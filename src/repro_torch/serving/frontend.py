"""Async serving front end: admission queue + SLO-aware continuous
batching (port of ``repro.serving.frontend``).

:func:`serve_batches` walks pre-formed batches synchronously — the right
loop for min-latency benchmarks, the wrong one for multi-user traffic
where requests arrive on their own timeline.  :class:`ServingFrontend`
puts an admission queue in front of the engine and forms batches
continuously: a batch closes when either the size target (``max_batch``)
or the time budget since its first request (``batch_timeout_ms``) is
hit, so a lone request never waits longer than the budget and a burst
fills batches immediately.  ``batch_pad`` pads candidate sets as in
:func:`serve_batches`, and ``pair_pad`` the coalesced distinct-pair
count, as the reference does to bound its compile counts.

Deadlines: with ``slo_ms`` set, a request that has already aged past the
SLO when its batch forms is rejected unserved — its future raises
:class:`DeadlineExceeded` and ``seine_serve_slo_misses_total`` counts it.
Serving a request that can no longer meet its deadline only steals
capacity from the ones that still can (load shedding keeps goodput from
collapsing under overload).

Batch-level SEINE optimizations (both exact — scores stay bitwise-equal
to per-request ``engine.score``):

* ``coalesce=True`` routes the formed batch through
  :class:`~repro_torch.serving.coalesce.CoalescingScorer`: (term, doc)
  pairs shared across the batch's queries resolve ONCE.
* ``cache_tiles > 0`` adds a
  :class:`~repro_torch.serving.tile_cache.PostingTileCache` under the
  coalescer, so pairs landing in recently-touched posting tiles skip
  the routed fetch entirely.

Latency accounting: per-request latency is arrival→completion (queue
wait included, up to the card having finished its scores: the number a
client sees), recorded into a thread-safe
:class:`~repro_torch.serving.engine.ServeStats` together with the
time-in-queue split and the queue-depth high-water mark.  Futures
resolve to host numpy arrays.

:func:`run_open_loop` drives a frontend under open-loop Poisson load
(exponential inter-arrival at ``target_qps``, submission never gated on
completion) and reports goodput — the fraction of submitted requests
served within the SLO — which is the serving metric that closed-loop
min-latency benchmarks cannot see.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from .coalesce import CoalescingScorer
from .engine import ServeStats, _sync
from .tile_cache import PostingTileCache


class DeadlineExceeded(Exception):
    """The request aged past the SLO in the queue and was rejected."""


@dataclass
class ServeRequest:
    """One queued request: candidates to score against one query."""
    query_terms: np.ndarray
    doc_ids: np.ndarray
    arrival_s: float
    future: Future = field(default_factory=Future)


_SHUTDOWN = object()


class ServingFrontend:
    """Continuous-batching async front end over a mesh-less engine.

    ``submit`` enqueues and returns a :class:`concurrent.futures.Future`
    resolving to the (B,) scores (host array); a dedicated worker thread
    forms and serves batches.  ``close`` drains every admitted request
    before joining the worker, so no future is left forever pending.

    Batch formation: a batch closes at ``max_batch`` requests or
    ``batch_timeout_ms`` after its first dequeue, whichever comes first;
    ``slo_ms`` rejects requests already past their deadline at dequeue
    (:class:`DeadlineExceeded`) instead of serving them late.
    ``coalesce`` dedupes (term, doc) pairs across the formed batch and
    ``cache_tiles`` keeps hot posting tiles device-resident — both
    exact (scores stay bitwise-equal to ``engine.score``).

    Live serving: :meth:`swap_engine` stages a replacement engine (e.g.
    over a rebuilt index) that the worker installs atomically between
    batches, the in-process half of an epoch swap, counted by
    ``seine_frontend_epoch_swaps_total``.  Over a
    :class:`~repro_torch.dist.live.LiveIndex` (``is_live``) the tile
    cache binds the immutable base generation, and when a compaction
    raises ``generation`` the worker rebinds it between batches (also
    counted as a swap).

    The worker thread enters ``torch.inference_mode()`` itself (grad
    mode is thread-local in torch).
    """

    def __init__(self, engine, *, max_batch: int = 8,
                 batch_timeout_ms: float = 2.0, batch_pad: int = 0,
                 slo_ms: Optional[float] = None, coalesce: bool = True,
                 cache_tiles: int = 0, pair_pad: int = 256):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if batch_timeout_ms < 0:
            raise ValueError("batch_timeout_ms must be >= 0, "
                             f"got {batch_timeout_ms}")
        if batch_pad < 0:
            raise ValueError(f"batch_pad must be >= 0, got {batch_pad}")
        if slo_ms is not None and slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {slo_ms}")
        if cache_tiles < 0:
            raise ValueError(f"cache_tiles must be >= 0, got {cache_tiles}")
        if cache_tiles > 0 and not coalesce:
            raise ValueError("cache_tiles > 0 requires coalesce=True: the "
                             "tile cache serves the coalesced distinct-"
                             "pair lookup")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.batch_timeout_s = batch_timeout_ms / 1e3
        self.batch_pad = int(batch_pad)
        self.slo_ms = slo_ms
        self.pair_pad = int(pair_pad)
        self._coalesce = bool(coalesce)
        # a LiveIndex's tile cache binds the immutable BASE generation
        # (the delta/tombstone tail is applied per batch by the
        # coalescer); compaction bumps index.generation and the worker
        # rebinds between batches — see _apply_swaps
        live = bool(getattr(engine.index, "is_live", False))
        self.cache = (PostingTileCache(
            engine.index.base if live else engine.index, cache_tiles)
            if cache_tiles > 0 else None)
        self.scorer = (CoalescingScorer(engine, cache=self.cache,
                                        pair_pad=pair_pad)
                       if coalesce else None)
        self.stats = ServeStats()
        # epoch-swap plumbing: a staged engine is installed by the
        # WORKER between batches, never mid-batch — in-flight requests
        # always finish against the engine that started them
        self._staged_engine = None
        self._live_gen = getattr(engine.index, "generation", None)
        self._swap_counter = obs.counter(
            "seine_frontend_epoch_swaps_total",
            "engine/generation swaps applied between batches")
        self._req_counter = obs.counter("seine_frontend_requests_total",
                                        "requests admitted to the queue")
        self._batch_counter = obs.counter("seine_frontend_batches_total",
                                          "batches formed and served")
        self._slo_counter = obs.counter(
            "seine_serve_slo_misses_total",
            "requests rejected unserved (aged past the SLO in queue)")
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="seine-frontend")
        self._worker.start()

    # -- admission -----------------------------------------------------

    def submit(self, query_terms, doc_ids) -> Future:
        if self._closed:
            raise RuntimeError("frontend is closed")
        req = ServeRequest(np.asarray(query_terms), np.asarray(doc_ids),
                           time.perf_counter())
        self._req_counter.inc()
        self._queue.put(req)
        return req.future

    def swap_engine(self, engine) -> None:
        """Stage a new engine for an atomic epoch swap.

        The worker installs it BETWEEN batches: the batch being served
        keeps its engine/scorer/cache to completion, the next batch sees
        only the new ones — no request ever scores against a torn
        mixture of generations.  The tile cache rebinds (invalidating
        every cached tile) and the coalescing scorer is rebuilt, so
        nothing of the old index serves the next batch.
        """
        if self._closed:
            raise RuntimeError("frontend is closed")
        self._staged_engine = engine

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain every admitted request, then stop the worker; raises
        ``TimeoutError`` if the worker is still running after
        ``timeout`` seconds (None waits as long as the drain takes)."""
        if not self._closed:
            self._closed = True
            # submissions stop before the sentinel enters, so everything
            # real sits ahead of it in FIFO order — the worker drains
            # all of it before it can see the sentinel
            self._queue.put(_SHUTDOWN)
        self._worker.join(timeout)
        if self._worker.is_alive():
            raise TimeoutError(f"the front end's worker did not stop "
                               f"within {timeout} s")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- batch formation ----------------------------------------------

    def _form_batch(self) -> Optional[List[ServeRequest]]:
        """Block for a first request, then gather until the size target
        or the time budget (measured from the first dequeue) is hit.
        Returns None when the shutdown sentinel surfaces with the queue
        already drained."""
        first = self._queue.get()
        if first is _SHUTDOWN:
            return None
        batch = [first]
        t_close = time.perf_counter() + self.batch_timeout_s
        while len(batch) < self.max_batch:
            left = t_close - time.perf_counter()
            if left <= 0:
                break
            try:
                nxt = self._queue.get(timeout=left)
            except queue.Empty:
                break
            if nxt is _SHUTDOWN:
                # keep draining: the current batch (and any queued
                # remainder) still gets served; re-post so the outer
                # loop terminates once the queue is truly empty
                self._queue.put(_SHUTDOWN)
                break
            batch.append(nxt)
        self.stats.note_queue_depth(self._queue.qsize())
        return batch

    def _apply_swaps(self) -> None:
        """Install any staged engine and track the live index's
        generation — both BETWEEN batches only (worker thread).  A
        compaction inside a LiveIndex publishes its new base atomically
        (readers are snapshot-safe already); the frontend's only job is
        to rebind the tile cache, whose cached tiles belong to the old
        generation's layout."""
        staged, self._staged_engine = self._staged_engine, None
        if staged is not None:
            self.engine = staged
            idx = staged.index
            if self.cache is not None:
                self.cache.swap_index(
                    idx.base if getattr(idx, "is_live", False) else idx)
            if self._coalesce:
                self.scorer = CoalescingScorer(staged, cache=self.cache,
                                               pair_pad=self.pair_pad)
            self._live_gen = getattr(idx, "generation", None)
            self._swap_counter.inc()
            return
        gen = getattr(self.engine.index, "generation", None)
        if gen is not None and gen != self._live_gen:
            if self.cache is not None:
                self.cache.swap_index(self.engine.index.base)
            self._live_gen = gen
            self._swap_counter.inc()

    def _run(self) -> None:
        with torch.inference_mode():
            while True:
                batch = self._form_batch()
                if batch is None:
                    return
                self._apply_swaps()
                try:
                    self._serve(batch)
                except BaseException as e:  # worker survives; futures carry
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)

    # -- serving -------------------------------------------------------

    def _serve(self, batch: List[ServeRequest]) -> None:
        self._batch_counter.inc()
        t_dequeue = time.perf_counter()
        live, waits = [], []
        for r in batch:
            wait_ms = (t_dequeue - r.arrival_s) * 1e3
            if self.slo_ms is not None and wait_ms > self.slo_ms:
                self._slo_counter.inc()
                r.future.set_exception(DeadlineExceeded(
                    f"queued {wait_ms:.1f} ms > SLO {self.slo_ms:.1f} ms"))
                continue
            if r.doc_ids.shape[0] == 0:
                # degenerate request, as in serve_batches: nothing to
                # score, and the pad id (docs[0]) does not exist.
                # record BEFORE resolving — a caller blocked on
                # result() may read stats immediately after
                self.stats.record(wait_ms, queue_ms=wait_ms)
                r.future.set_result(np.zeros((0,), np.float32))
                continue
            live.append(r)
            waits.append(wait_ms)
        if not live:
            return
        pad = self.batch_pad

        def padded(docs):
            n = docs.shape[0]
            if pad > 0 and n % pad:
                m = -(-n // pad) * pad
                docs = np.concatenate(
                    [docs, np.full(m - n, docs[0], docs.dtype)])
            return docs

        with obs.span("frontend.batch"):
            if self.scorer is not None:
                scores = self.scorer.score_batch(
                    [(r.query_terms, padded(r.doc_ids)) for r in live])
            else:
                scores = [self.engine.score(r.query_terms,
                                            padded(r.doc_ids))
                          for r in live]
            for r, w, s in zip(live, waits, scores):
                _sync(s)
                done_ms = (time.perf_counter() - r.arrival_s) * 1e3
                self.stats.record(done_ms, queue_ms=w)
                r.future.set_result(s.cpu().numpy()[:r.doc_ids.shape[0]])


@dataclass
class OpenLoopResult:
    """Outcome of one open-loop run.  ``goodput`` is the fraction of
    SUBMITTED requests served within the SLO (rejected requests and
    served-but-late completions both count against it); with no SLO it
    degenerates to the served fraction."""
    n_submitted: int
    n_served: int
    n_rejected: int
    goodput: float
    stats: ServeStats


def run_open_loop(frontend: ServingFrontend,
                  requests: Sequence[Tuple[np.ndarray, np.ndarray]],
                  *, target_qps: float, seed: int = 0,
                  timeout: Optional[float] = None) -> OpenLoopResult:
    """Submit ``requests`` on a Poisson timeline at ``target_qps``.

    Open loop: inter-arrival gaps are exponential draws (seeded, so
    compared paths replay the SAME arrival schedule) and submission
    never waits on completions — queueing delay under overload shows up
    in the latency tail instead of silently throttling the offered
    load, which is exactly the failure mode closed-loop benchmarks hide.
    Blocks until every future resolves (the frontend stays open), at
    most ``timeout`` seconds for each (None: no limit).  The gaps come
    from numpy's ``RandomState(seed)``, so the arrival times equal the
    reference's for the same seed.
    """
    if target_qps <= 0:
        raise ValueError(f"target_qps must be > 0, got {target_qps}")
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / target_qps, size=len(requests))
    futures = []
    t_next = time.perf_counter()
    for (q, d), gap in zip(requests, gaps):
        t_next += gap
        now = time.perf_counter()
        if t_next > now:
            time.sleep(t_next - now)
        futures.append(frontend.submit(q, d))
    served = rejected = within = 0
    for f in futures:
        # read a rejection without raising it: a raised exception keeps
        # this frame, and with it the front end and its engine, in a
        # reference cycle (frame -> futures -> exception -> traceback)
        exc = f.exception(timeout=timeout)
        if exc is None:
            served += 1
        elif isinstance(exc, DeadlineExceeded):
            rejected += 1
        else:
            raise exc
    if frontend.slo_ms is None:
        goodput = served / max(len(futures), 1)
    else:
        lat = np.asarray(frontend.stats.latencies_ms, dtype=np.float64)
        within = int((lat[-served:] <= frontend.slo_ms).sum()) if served \
            else 0
        goodput = within / max(len(futures), 1)
    return OpenLoopResult(len(futures), served, rejected, goodput,
                          frontend.stats)
