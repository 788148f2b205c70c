"""The port's serving front end: coalescing and tile-cache exactness,
batching edges and the open-loop runner.

Mirrors ``tests/test_frontend.py`` on the port.  Coalesced and cached
scores are held to rtol=0/atol=0 against the port's per-request
``engine.score``, across retrievers, shard counts and the sub-sharded
Zipfian corpus (the reference's own contract); the coalescing plan and
the open-loop arrival schedule are held against the JAX package's.
Every ``Future.result`` and ``close`` takes a timeout.
"""
import sys
import threading
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro.serving import coalesce as jax_coalesce
from repro.serving import frontend as jax_frontend
from repro_torch import obs
from repro_torch.data.synth_corpus import build_zipfian_index
from repro_torch.dist.sharding import partition_index
from repro_torch.kernels.csr_lookup import ops as lookup_ops
from repro_torch.retrievers import get_retriever
from repro_torch.serving import (CoalescingScorer, DeadlineExceeded,
                                 PostingTileCache, SeineEngine, ServeStats,
                                 ServingFrontend, plan_coalesced,
                                 run_open_loop)
from repro_torch.serving import coalesce, frontend

K_SWEEP = (1, 2, 4)
RETRIEVERS = ("knrm", "deeptilebars", "hint", "deepimpact")
WAIT = 120          # seconds any future or close may take


@pytest.fixture(scope="module")
def hot_term_index():
    """The port's build of the reference's hot-term corpus (the same
    numpy draws as tests/conftest.py's fixture)."""
    return build_zipfian_index(device="cpu")


def _counter(name):
    m = obs.REGISTRY.get(name)
    return m.get() if m is not None else 0.0


def _engine(index, retriever="deepimpact"):
    spec = get_retriever(retriever)
    params = spec.init(torch.Generator().manual_seed(0), index.n_b,
                       index.functions, device="cpu")
    return SeineEngine(index, retriever, params)


def _requests(index, n, seed=0, vocab=40):
    rng = np.random.RandomState(seed)
    reqs = []
    for r in range(n):
        q = rng.randint(0, vocab, size=4 + r % 3).astype(np.int32)
        if r % 3 == 1:
            q[1] = q[0]   # duplicated in-query term
            q[-1] = -1    # pad slot
        docs = rng.randint(0, index.n_docs, size=8).astype(np.int32)
        reqs.append((q, docs))
    return reqs


def _score(eng, q, d):
    return eng.score(q, d).numpy()


def _pairs(pidx, t, d):
    return pidx.lookup_pairs(torch.from_numpy(t)[:, None],
                             torch.from_numpy(d))[:, 0].numpy()


# ---------------------------------------------------------------------------
# host-side coalescing plan
# ---------------------------------------------------------------------------
PLANS = {
    "two_requests": ([(np.array([3, 1, 3, -1], np.int32),
                       np.array([5, 2], np.int32)),
                      (np.array([1, 7], np.int32),
                       np.array([2, 9, 5], np.int32))], 0),
    "duplicate_terms": ([(np.array([4, 4, 4], np.int32),
                          np.array([1, 2], np.int32))], 0),
    "pair_pad": ([(np.array([2], np.int32),
                   np.array([0, 1, 2], np.int32))], 8),
    "negative_docs": ([(np.array([1], np.int32),
                        np.array([-3, 3], np.int32))], 0),
    "empty": ([], 16),
}


class TestPlanCoalesced:
    @pytest.mark.parametrize("case", sorted(PLANS))
    @pytest.mark.parametrize("flat", [False, True])
    def test_bitwise_equal_to_jax(self, case, flat, monkeypatch):
        """The factored plan and its flat fallback (forced by a zero grid
        cap) against the reference's, array for array."""
        reqs, pad = PLANS[case]
        if flat:
            monkeypatch.setattr(coalesce, "_GRID_CAP", 0)
            monkeypatch.setattr(jax_coalesce, "_GRID_CAP", 0)
        got = plan_coalesced(reqs, pad)
        want = jax_coalesce.plan_coalesced(reqs, pad)
        assert got[3] == want[3]
        for a, b in ((got[0], want[0]), (got[1], want[1])):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert len(got[2]) == len(want[2])
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)

    def test_inverse_reconstructs_every_pair(self):
        reqs, _ = PLANS["two_requests"]
        terms, docs, inverses, n = plan_coalesced(reqs)
        assert n == len(set(zip(terms[:n].tolist(), docs[:n].tolist())))
        for (q, d), inv in zip(reqs, inverses):
            want = [(int(t), int(dd)) for dd in d for t in q]
            assert [(int(terms[i]), int(docs[i])) for i in inv] == want

    def test_random_batches_match_jax(self, hot_term_index):
        reqs = _requests(hot_term_index, 9, seed=11)
        for pad in (0, 16, 256):
            got = plan_coalesced(reqs, pad)
            want = jax_coalesce.plan_coalesced(reqs, pad)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            for a, b in zip(got[2], want[2]):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# coalesced scoring vs the uncoalesced engine (bitwise)
# ---------------------------------------------------------------------------
class TestCoalescedParity:
    @pytest.mark.parametrize("retriever", RETRIEVERS)
    @pytest.mark.parametrize("k", K_SWEEP)
    def test_bitwise_equal_across_retrievers_and_shards(
            self, hot_term_index, retriever, k):
        eng = _engine(partition_index(hot_term_index, k), retriever)
        sc = CoalescingScorer(eng, pair_pad=16)
        reqs = _requests(hot_term_index, 5, seed=k)
        for (q, d), g in zip(reqs, sc.score_batch(reqs)):
            np.testing.assert_array_equal(g.numpy(), _score(eng, q, d))

    @pytest.mark.parametrize("k", [4, 8])
    def test_sub_sharded_zipfian_parity(self, hot_term_index, k):
        """Doc-range sub-shards route per (term, doc) pair."""
        p = partition_index(hot_term_index, k)
        assert p.split_term is not None
        eng = _engine(p)
        sc = CoalescingScorer(eng, pair_pad=16)
        reqs = _requests(hot_term_index, 6, seed=3)
        for (q, d), g in zip(reqs, sc.score_batch(reqs)):
            np.testing.assert_array_equal(g.numpy(), _score(eng, q, d))

    @pytest.mark.parametrize("layout", ["single", "k4", "k4_packed_q8"])
    def test_kernel_dataflow_parity(self, hot_term_index, layout,
                                    monkeypatch):
        """With the ops routed to the kernels' dataflow (their plain
        versions here), the distinct pairs take the lookup kernel with
        per-pair routing; scores stay bitwise equal to engine.score on
        the same route."""
        monkeypatch.setattr(lookup_ops, "_use_kernel",
                            lambda impl, like: impl in (None, "kernel"))
        idx = hot_term_index if layout == "single" else partition_index(
            hot_term_index, 4, codec="packed-q8" if "q8" in layout
            else "none")
        eng = _engine(idx, "knrm")
        sc = CoalescingScorer(eng, pair_pad=16)
        reqs = _requests(hot_term_index, 5, seed=2)
        for (q, d), g in zip(reqs, sc.score_batch(reqs)):
            np.testing.assert_array_equal(g.numpy(), _score(eng, q, d))

    def test_in_query_duplicates_route_once(self, hot_term_index):
        eng = _engine(partition_index(hot_term_index, 2))
        sc = CoalescingScorer(eng, pair_pad=0)
        q = np.array([5, 5, 5, 5], np.int32)
        d = np.array([1, 2, 3], np.int32)
        before = _counter("seine_coalesce_distinct_pairs_total")
        (got,) = sc.score_batch([(q, d)])
        assert _counter("seine_coalesce_distinct_pairs_total") \
            - before == 3          # 3 distinct pairs, not 12 slots
        np.testing.assert_array_equal(got.numpy(), _score(eng, q, d))

    def test_rejects_meshed_engine(self):
        class FakeMeshed:
            mesh = object()
        with pytest.raises(ValueError, match="mesh-less"):
            CoalescingScorer(FakeMeshed())


# ---------------------------------------------------------------------------
# posting-tile cache
# ---------------------------------------------------------------------------
class TestPostingTileCache:
    @pytest.mark.parametrize("codec", ("none", "packed", "packed-q8"))
    def test_parity_and_second_pass_hits(self, hot_term_index, codec):
        pidx = partition_index(hot_term_index, 4, codec=codec)
        cache = PostingTileCache(pidx, budget_tiles=8)
        rng = np.random.RandomState(1)
        t = np.concatenate([np.array([0, 0, -1, 200, 3], np.int32),
                            rng.randint(-1, 45, size=60).astype(np.int32)])
        d = np.concatenate([np.array([0, 63, 2, 1, -3], np.int32),
                            rng.randint(-2, 70, size=60).astype(np.int32)])
        want = _pairs(pidx, t, d)
        np.testing.assert_array_equal(cache.lookup(t, d).numpy(), want)
        h0 = _counter("seine_tile_cache_hits_total")
        m0 = _counter("seine_tile_cache_misses_total")
        np.testing.assert_array_equal(cache.lookup(t, d).numpy(), want)
        assert _counter("seine_tile_cache_hits_total") > h0
        assert _counter("seine_tile_cache_misses_total") == m0

    def test_eviction_pressure_stays_exact(self):
        idx = build_zipfian_index(n_docs=512, vocab=64, n_hot=2,
                                  tail_decay=1.2, seed=5, device="cpu")
        pidx = partition_index(idx, 2, codec="packed", codec_tile=64)
        cache = PostingTileCache(pidx, budget_tiles=2)
        e0 = _counter("seine_tile_cache_evictions_total")
        rng = np.random.RandomState(2)
        for _ in range(4):
            t = rng.randint(0, 64, size=40).astype(np.int32)
            d = rng.randint(0, 512, size=40).astype(np.int32)
            np.testing.assert_array_equal(cache.lookup(t, d).numpy(),
                                          _pairs(pidx, t, d))
        assert _counter("seine_tile_cache_evictions_total") > e0

    def test_batch_working_set_over_budget_spills_exactly(self):
        idx = build_zipfian_index(n_docs=512, vocab=64, n_hot=2,
                                  tail_decay=1.2, seed=5, device="cpu")
        pidx = partition_index(idx, 4, codec="packed-q8", codec_tile=64)
        cache = PostingTileCache(pidx, budget_tiles=1)
        rng = np.random.RandomState(3)
        t = rng.randint(0, 64, size=120).astype(np.int32)
        d = rng.randint(0, 512, size=120).astype(np.int32)
        o0 = _counter("seine_tile_cache_overflow_pairs_total")
        np.testing.assert_array_equal(cache.lookup(t, d).numpy(),
                                      _pairs(pidx, t, d))
        assert _counter("seine_tile_cache_overflow_pairs_total") > o0

    def test_stale_tile_never_served_after_swap(self):
        # same CSR structure, different values: a stale tile would
        # return the old values bit for bit
        a = build_zipfian_index(seed=0, device="cpu")
        pa = partition_index(a, 2, codec="packed")
        t = np.arange(20, dtype=np.int32) % 5
        d = (np.arange(20, dtype=np.int32) * 3) % a.n_docs
        cache = PostingTileCache(pa, budget_tiles=8)
        want_a = _pairs(pa, t, d)
        np.testing.assert_array_equal(cache.lookup(t, d).numpy(), want_a)
        pb = partition_index(build_zipfian_index(seed=9, device="cpu"), 2,
                             codec="packed")
        epoch = cache.epoch
        cache.swap_index(pb)
        assert cache.epoch == epoch + 1
        want_b = _pairs(pb, t, d)
        np.testing.assert_array_equal(cache.lookup(t, d).numpy(), want_b)
        assert not np.array_equal(want_a, want_b)

    def test_rejects_bad_budget_and_plain_index(self, hot_term_index):
        pidx = partition_index(hot_term_index, 2)
        with pytest.raises(ValueError, match="budget"):
            PostingTileCache(pidx, budget_tiles=0)
        with pytest.raises(ValueError, match="PartitionedIndex"):
            PostingTileCache(hot_term_index, budget_tiles=4)


# ---------------------------------------------------------------------------
# async front end
# ---------------------------------------------------------------------------
class TestServingFrontend:
    @pytest.mark.parametrize("k", K_SWEEP)
    @pytest.mark.parametrize("mode", ["naive", "coalesce", "cache"])
    def test_async_scores_bitwise_equal(self, hot_term_index, k, mode):
        eng = _engine(partition_index(hot_term_index, k, codec="packed"))
        reqs = _requests(hot_term_index, 10, seed=4)
        kw = {"naive": dict(coalesce=False), "coalesce": {},
              "cache": dict(cache_tiles=8)}[mode]
        fe = ServingFrontend(eng, max_batch=4, batch_timeout_ms=5,
                             batch_pad=4, pair_pad=16, **kw)
        try:
            futs = [fe.submit(q, d) for q, d in reqs]
            for (q, d), f in zip(reqs, futs):
                got = f.result(timeout=WAIT)
                assert isinstance(got, np.ndarray)
                np.testing.assert_array_equal(got, _score(eng, q, d))
        finally:
            fe.close(timeout=WAIT)
        assert fe.stats.n_requests == len(reqs)
        assert fe.stats.queue_ms_per_request >= 0.0

    def test_lone_request_served_after_timeout(self, hot_term_index):
        eng = _engine(partition_index(hot_term_index, 2))
        fe = ServingFrontend(eng, max_batch=64, batch_timeout_ms=10)
        try:
            q, d = _requests(hot_term_index, 1)[0]
            np.testing.assert_array_equal(
                fe.submit(q, d).result(timeout=WAIT), _score(eng, q, d))
        finally:
            fe.close(timeout=WAIT)

    def test_batch_of_one(self, hot_term_index):
        eng = _engine(partition_index(hot_term_index, 2))
        fe = ServingFrontend(eng, max_batch=1, batch_timeout_ms=0,
                             coalesce=False)
        try:
            q, d = _requests(hot_term_index, 1)[0]
            np.testing.assert_array_equal(
                fe.submit(q, d).result(timeout=WAIT), _score(eng, q, d))
        finally:
            fe.close(timeout=WAIT)
        assert fe.stats.n_requests == 1

    def test_empty_queue_close_is_prompt(self, hot_term_index):
        eng = _engine(partition_index(hot_term_index, 2))
        fe = ServingFrontend(eng, max_batch=8, batch_timeout_ms=50)
        time.sleep(0.05)         # the worker is blocked on an empty queue
        t0 = time.perf_counter()
        fe.close(timeout=WAIT)
        assert time.perf_counter() - t0 < 5.0
        assert fe.stats.n_requests == 0

    def test_deadline_expired_rejected_and_counted(self, hot_term_index):
        eng = _engine(partition_index(hot_term_index, 2))
        m0 = _counter("seine_serve_slo_misses_total")
        # an SLO far below one request's service time: requests queued
        # behind the first age past it
        fe = ServingFrontend(eng, max_batch=1, batch_timeout_ms=0,
                             coalesce=False, slo_ms=0.001)
        outcomes = []
        try:
            for f in [fe.submit(q, d) for q, d in
                      _requests(hot_term_index, 6, seed=6)]:
                try:
                    f.result(timeout=WAIT)
                    outcomes.append("served")
                except DeadlineExceeded:
                    outcomes.append("rejected")
        finally:
            fe.close(timeout=WAIT)
        n_rej = outcomes.count("rejected")
        assert n_rej >= 1
        assert _counter("seine_serve_slo_misses_total") - m0 == n_rej

    def test_empty_candidates_short_circuit(self, hot_term_index):
        eng = _engine(partition_index(hot_term_index, 2))
        fe = ServingFrontend(eng, max_batch=2, batch_timeout_ms=1)
        try:
            got = fe.submit(np.array([1, 2], np.int32),
                            np.zeros(0, np.int32)).result(timeout=WAIT)
        finally:
            fe.close(timeout=WAIT)
        assert got.shape == (0,) and got.dtype == np.float32

    def test_submit_after_close_raises(self, hot_term_index):
        eng = _engine(partition_index(hot_term_index, 2))
        fe = ServingFrontend(eng)
        fe.close(timeout=WAIT)
        with pytest.raises(RuntimeError, match="closed"):
            fe.submit(np.array([1], np.int32), np.array([0], np.int32))
        with pytest.raises(RuntimeError, match="closed"):
            fe.swap_engine(eng)
        fe.close(timeout=WAIT)   # idempotent

    def test_invalid_config_rejected(self, hot_term_index):
        eng = _engine(partition_index(hot_term_index, 2))
        for kw, match in ((dict(max_batch=0), "max_batch"),
                          (dict(batch_timeout_ms=-1), "batch_timeout_ms"),
                          (dict(batch_pad=-1), "batch_pad"),
                          (dict(slo_ms=-1), "slo_ms"),
                          (dict(cache_tiles=-1), "cache_tiles"),
                          (dict(coalesce=False, cache_tiles=4), "coalesce"),
                          (dict(pair_pad=-1), "pair_pad")):
            with pytest.raises(ValueError, match=match):
                ServingFrontend(eng, **kw)

    def test_swap_engine_serves_the_new_index(self, hot_term_index):
        """A staged engine serves every batch formed after the swap, the
        cache rebinds (epoch + 1) and the swap is counted."""
        a = _engine(partition_index(hot_term_index, 2))
        b = _engine(partition_index(build_zipfian_index(seed=9,
                                                        device="cpu"), 2,
                                    codec="packed"))
        reqs = _requests(hot_term_index, 4, seed=8)
        s0 = _counter("seine_frontend_epoch_swaps_total")
        fe = ServingFrontend(a, max_batch=2, batch_timeout_ms=1,
                             cache_tiles=8)
        try:
            for (q, d), f in zip(reqs, [fe.submit(q, d) for q, d in reqs]):
                np.testing.assert_array_equal(f.result(timeout=WAIT),
                                              _score(a, q, d))
            epoch = fe.cache.epoch
            fe.swap_engine(b)
            for (q, d), f in zip(reqs, [fe.submit(q, d) for q, d in reqs]):
                np.testing.assert_array_equal(f.result(timeout=WAIT),
                                              _score(b, q, d))
        finally:
            fe.close(timeout=WAIT)
        assert fe.cache.epoch == epoch + 1
        assert _counter("seine_frontend_epoch_swaps_total") == s0 + 1

    def test_open_loop_accounting(self, hot_term_index):
        eng = _engine(partition_index(hot_term_index, 2))
        reqs = _requests(hot_term_index, 8, seed=7)
        fe = ServingFrontend(eng, max_batch=4, batch_timeout_ms=2,
                             slo_ms=60_000, pair_pad=16)
        try:
            res = run_open_loop(fe, reqs, target_qps=400, seed=1,
                                timeout=WAIT)
        finally:
            fe.close(timeout=WAIT)
        assert res.n_submitted == 8
        assert res.n_served + res.n_rejected == 8
        assert 0.0 <= res.goodput <= 1.0
        assert res.stats is fe.stats
        with pytest.raises(ValueError, match="target_qps"):
            run_open_loop(fe, reqs, target_qps=0)


class _FakeClock:
    """A clock that ``sleep`` advances, for both packages' open-loop runs."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now

    def sleep(self, s):
        self.now += s


class _RecordingFrontend:
    """Records the clock at each submission; every future is done."""

    slo_ms = None

    def __init__(self, clock):
        self.clock, self.arrivals = clock, []
        self.stats = ServeStats()

    def submit(self, q, d):
        self.arrivals.append(self.clock.now)
        f = Future()
        f.set_result(np.zeros(0, np.float32))
        return f


@pytest.mark.parametrize("qps,seed", [(400.0, 1), (1500.0, 7)])
def test_open_loop_arrivals_equal_the_reference(monkeypatch, qps, seed):
    """The Poisson timeline comes from numpy with the same seed, so the
    submission times are the reference's, to the bit."""
    arrivals = []
    for mod in (frontend, jax_frontend):
        clock = _FakeClock()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=clock.perf_counter, sleep=clock.sleep))
        fe = _RecordingFrontend(clock)
        res = mod.run_open_loop(fe, [(None, None)] * 20, target_qps=qps,
                                seed=seed)
        assert res.n_served == 20 and res.goodput == 1.0
        arrivals.append(fe.arrivals)
    assert arrivals[0] == arrivals[1]
    assert arrivals[0][0] > 100.0 and len(arrivals[0]) == 20


# ---------------------------------------------------------------------------
# ServeStats thread safety + queue fields
# ---------------------------------------------------------------------------
class TestServeStatsConcurrency:
    def test_concurrent_recorders_and_readers(self):
        stats = ServeStats(window=1 << 12)
        n_threads, per = 8, 400
        stop = threading.Event()

        def write():
            for i in range(per):
                stats.record(float(i % 50), queue_ms=float(i % 7))
                stats.note_queue_depth(i % 13)

        def read():
            while not stop.is_set():
                stats.percentile_ms(95.0)
                _ = stats.queue_ms_per_request

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            readers = [threading.Thread(target=read) for _ in range(2)]
            writers = [threading.Thread(target=write)
                       for _ in range(n_threads)]
            for t in readers + writers:
                t.start()
            for t in writers:
                t.join(timeout=WAIT)
            stop.set()
            for t in readers:
                t.join(timeout=WAIT)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in readers + writers)
        assert stats.n_requests == n_threads * per
        want_total = n_threads * sum(i % 50 for i in range(per))
        assert stats.total_ms == pytest.approx(want_total)
        want_queue = sum(i % 7 for i in range(per)) / per
        assert stats.queue_ms_per_request == pytest.approx(want_queue)
        assert stats.max_queue_depth == 12
        assert stats.percentile_ms(50.0) >= 0.0

    def test_queue_depth_high_water(self):
        stats = ServeStats()
        for depth in (3, 9, 1):
            stats.note_queue_depth(depth)
        assert stats.queue_depth == 1
        assert stats.max_queue_depth == 9
