"""The port's live index (``repro_torch.dist.live``) on the CPU.

Against the JAX package: the same mutation sequence (base of the first
half of ``seine_world``, insert of the second half, deletes, an update,
a compaction, an insert after it) on a JAX ``LiveIndex`` and on the
port's, the port's builder carrying the JAX provider table and
interaction parameters.  Ids, ``nnz``, ``delta_nnz``, tombstones,
generation and the sampled found counts are bitwise; M values and KNRM
scores (params carried over by ``convert.params_from_jax``) at the
build's bar, rtol 1e-4 / atol 1e-5, held against the JAX ``impl="jnp"``
paths, not the Pallas interpreter.

Within the port, the reference's contracts (tests/test_live_index.py):
insert-only state equals a rebuild bit for bit, deletes zero a doc's
rows and keep it out of every top-k, compaction is invisible under
``none``, ``packed`` and ``packed-q8``, inserts after a compaction,
background compaction, the ``ckpt_dir`` epoch swap, ``found_counts``,
queries stable while a compaction runs, and the front end through one.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.live import LiveIndex as JaxLive
from repro.dist.live import found_counts as jax_found_counts
from repro.retrievers import get_retriever as jax_get
from repro.serving.engine import make_qmeta as jax_qmeta
from repro_torch import obs
from repro_torch.ckpt import load_index
from repro_torch.configs import seine_smoke
from repro_torch.convert import (interaction_params_from_jax,
                                 params_from_jax, provider_from_numpy)
from repro_torch.core.builder import IndexBuilder
from repro_torch.core.segment import segment_corpus
from repro_torch.core.vocab import build_vocabulary
from repro_torch.data.synth_corpus import generate
from repro_torch.dist.live import LiveIndex, found_counts, live_index
from repro_torch.retrievers import get_retriever
from repro_torch.serving import SeineEngine, ServingFrontend, make_qmeta
import torch_threads  # noqa: F401  (PyTorch threads per test process)

TOL = dict(rtol=1e-4, atol=1e-5)
QUERY = (3, 0, -1, 7, 99, 5)    # dup term, pad slot, out-of-vocab id
ID_FIELDS = ("term_offsets", "doc_ids", "term_to_shard", "range_lo",
             "range_hi", "doc_len", "seg_len")


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():          # the retrievers' params carry grads
        yield


@pytest.fixture(scope="module")
def port(seine_world):
    """The port's corpus pipeline on seine_world's seed, and a builder on
    the CPU over the JAX provider table and interaction parameters."""
    w = seine_world
    cfg = seine_smoke()
    ds = generate(cfg, seed=0)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens,
                             keep_frac=cfg.vocab_keep_frac)
    toks, segs = segment_corpus([vocab.map_tokens(d) for d in ds.docs],
                                cfg.n_segments, max_len=160,
                                window=cfg.tile_window,
                                smooth=cfg.tile_smooth)
    np.testing.assert_array_equal(toks, w["toks"])
    provider = provider_from_numpy(np.asarray(w["provider"].table()),
                                   device="cpu")
    ip = interaction_params_from_jax(w["builder"].ip, device="cpu")
    builder = IndexBuilder(cfg, vocab, provider, ip=ip, device="cpu")
    return dict(builder=builder, toks=toks, segs=segs)


def _halves(p):
    h = p["toks"].shape[0] // 2
    return ((p["toks"][:h], p["segs"][:h]), (p["toks"][h:], p["segs"][h:]))


def _mk_live(p, k, *, codec="none", ckpt_dir=None, insert=True):
    """Base over the first half, the second half inserted."""
    (t0, s0), (t1, s1) = _halves(p)
    base = p["builder"].build_partitioned(t0, s0, k, batch_size=16,
                                          codec=codec)
    live = LiveIndex(base, p["builder"].pipeline, batch_size=16,
                     ckpt_dir=ckpt_dir)
    if insert:
        ids = live.insert(t1, s1)
        np.testing.assert_array_equal(
            ids, np.arange(base.n_docs, base.n_docs + t1.shape[0]))
    return live


def _q():
    return torch.tensor(QUERY, dtype=torch.int32)


def _knrm(index):
    spec = get_retriever("knrm")
    return spec, spec.init(torch.Generator().manual_seed(0), index.n_b,
                           index.functions, device="cpu")


def _score_fn(index, spec, params):
    n = index.n_docs
    q = _q()

    def score_block(m, docs):
        meta = make_qmeta(index, q, docs.clamp(0, n - 1))
        return spec.score(params, m, meta, index.functions)
    return score_block


@pytest.fixture(scope="module")
def full2(port):
    return port["builder"].build_partitioned(port["toks"], port["segs"], 2,
                                             batch_size=16)


@pytest.fixture(scope="module")
def live2(port):
    """Insert-only live index; the parity tests treat it as read-only."""
    return _mk_live(port, 2)


# -- against the JAX package --------------------------------------------------

def _jax_live(seine_world, k):
    w = seine_world
    h = w["toks"].shape[0] // 2
    builder = w["builder"]
    base = builder.build_partitioned(w["toks"][:h], w["segs"][:h], k,
                                     batch_size=16)
    return JaxLive(base, builder._pipeline(), batch_size=16)


def _held_against_jax(live, jlive, params, jparams, what):
    """State bitwise, M and KNRM scores at the build's bar, found counts
    bitwise, over every doc and the adversarial query."""
    assert live.n_docs == jlive.n_docs, what
    assert live.nnz == jlive.nnz, what
    assert live.delta_nnz == jlive.delta_nnz, what
    assert live.tombstones == jlive.tombstones, what
    assert live.generation == jlive.generation, what
    for f in ID_FIELDS:
        np.testing.assert_array_equal(getattr(live.base, f).numpy(),
                                      np.asarray(getattr(jlive.base, f)),
                                      err_msg=f"{what}: base {f}")
        if jlive.view.delta is not None:
            np.testing.assert_array_equal(
                getattr(live.view.delta, f).numpy(),
                np.asarray(getattr(jlive.view.delta, f)),
                err_msg=f"{what}: delta {f}")
    q = _q()
    docs = torch.arange(-1, live.n_docs + 2, dtype=torch.int32)
    jq, jd = jnp.asarray(q.numpy()), jnp.asarray(docs.numpy())
    m = live.qd_matrix(q, docs)
    jm = jlive.qd_matrix(jq, jd, impl="jnp")
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL,
                               err_msg=what)
    assert ((m != 0).numpy() == (np.asarray(jm) != 0)).all(), what
    spec, jspec = get_retriever("knrm"), jax_get("knrm")
    d = docs.clamp(0, live.n_docs - 1)
    s = spec.score(params, live.qd_matrix(q, d), make_qmeta(live, q, d),
                   live.functions)
    jdd = jnp.asarray(d.numpy())
    js = jspec.score(jparams, jlive.qd_matrix(jq, jdd, impl="jnp"),
                     jax_qmeta(jlive, jq, jdd), jlive.functions)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL,
                               err_msg=what)
    got = found_counts(live.view, q, d)
    want = tuple(int(x) for x in jax_found_counts(jlive.view, jq, jdd))
    assert got == want, what


@pytest.mark.parametrize("k", [1, 2])
def test_mutation_sequence_matches_jax(seine_world, port, k):
    w = seine_world
    jlive = _jax_live(w, k)
    live = _mk_live(port, k, insert=False)
    jparams = jax_get("knrm").init(jax.random.key(0), live.n_b,
                                   live.functions)
    params = params_from_jax("knrm", jparams, device="cpu")
    _held_against_jax(live, jlive, params, jparams, "base")
    (t0, s0), (t1, s1) = _halves(port)
    np.testing.assert_array_equal(live.insert(t1, s1),
                                  np.asarray(jlive.insert(t1, s1)))
    _held_against_jax(live, jlive, params, jparams, "insert")
    dead = [1, 4, live.n_docs - 3]
    assert live.delete(dead) == jlive.delete(dead) == 3
    _held_against_jax(live, jlive, params, jparams, "delete")
    np.testing.assert_array_equal(live.update([2], t0[5:7], s0[5:7]),
                                  np.asarray(jlive.update([2], t0[5:7],
                                                          s0[5:7])))
    _held_against_jax(live, jlive, params, jparams, "update")
    live.compact()
    jlive.compact()
    _held_against_jax(live, jlive, params, jparams, "compact")
    np.testing.assert_array_equal(live.insert(t0[:9], s0[:9]),
                                  np.asarray(jlive.insert(t0[:9], s0[:9])))
    _held_against_jax(live, jlive, params, jparams, "insert after compact")


# -- insert-only parity within the port: live == rebuild, bit for bit ---------

def test_stats_bitwise(live2, full2):
    assert live2.n_docs == full2.n_docs and live2.nnz == full2.nnz
    for f in ("doc_len", "seg_len", "idf"):
        assert torch.equal(getattr(live2, f), getattr(full2, f)), f
    assert live2.avg_doc_len.item() == full2.avg_doc_len.item()
    assert live2.delta_nnz > 0 and live2.generation == 0
    assert live2.tombstones == 0 and live2.view.alive is None


@pytest.mark.parametrize("k", [1, 2, 4])
def test_insert_parity_bitwise(port, k):
    live = _mk_live(port, k)
    full = port["builder"].build_partitioned(port["toks"], port["segs"], k,
                                             batch_size=16)
    q = _q()
    docs = torch.arange(-1, full.n_docs + 2, dtype=torch.int32)
    for impl in (None, "kernel"):
        assert torch.equal(live.qd_matrix(q, docs, impl=impl),
                           full.qd_matrix(q, docs, impl=impl))
    rng = np.random.RandomState(3)
    t = torch.from_numpy(rng.randint(-1, 60, size=(24, 5)).astype(np.int32))
    d = torch.from_numpy(rng.randint(0, full.n_docs, 24).astype(np.int32))
    assert torch.equal(live.lookup_pairs(t, d), full.lookup_pairs(t, d))
    tt, dd = t[:, 0], d
    assert torch.equal(live.view.lookup_pair_rows(tt, dd),
                       full.lookup_pair_rows(tt, dd))
    spec, params = _knrm(full)
    for kk in (1, 5, full.n_docs + 3):
        for block in (None, 7):
            sv, si = live.retrieve_topk(q, kk, _score_fn(live, spec, params),
                                        doc_block=block)
            fv, fi = full.retrieve_topk(q, kk, _score_fn(full, spec, params),
                                        doc_block=block)
            assert torch.equal(si, fi) and torch.equal(sv, fv)


def test_engine_score_and_retrieve_bitwise(live2, full2):
    spec, params = _knrm(full2)
    le = SeineEngine(live2, "knrm", params)
    fe = SeineEngine(full2, "knrm", params)
    rng = np.random.RandomState(11)
    for _ in range(4):
        q = rng.randint(-1, 80, 6).astype(np.int32)
        docs = rng.randint(0, full2.n_docs, 8).astype(np.int32)
        assert torch.equal(le.score(q, docs), fe.score(q, docs))
        lv, li = le.retrieve(q, 5)
        fv, fi = fe.retrieve(q, 5)
        assert torch.equal(li, fi) and torch.equal(lv, fv)
    with pytest.raises(ValueError, match="already partitioned"):
        SeineEngine(live2, "knrm", params, partition="term")
    with pytest.raises(ValueError, match="conflicts"):
        SeineEngine(live2, "knrm", params, codec="packed")


# -- deletes and updates --------------------------------------------------------

def test_deletes_zero_rows_and_leave_every_top_k(port, full2):
    live = _mk_live(port, 2)
    dead = np.array([0, 2, 5, live.n_docs - 1])
    assert live.delete(dead) == 4 and live.tombstones == 4
    assert live.delete([0, 2]) == 0                  # already dead
    q = _q()
    docs = torch.arange(live.n_docs, dtype=torch.int32)
    want = full2.qd_matrix(q, docs).clone()
    want[torch.from_numpy(dead)] = 0.0
    for impl in (None, "kernel"):
        assert torch.equal(live.qd_matrix(q, docs, impl=impl), want)
    spec, params = _knrm(live)
    m = live.qd_matrix(q, docs)
    scores = spec.score(params, m, make_qmeta(live, q, docs),
                        live.functions).numpy().copy()
    scores[dead] = -np.inf
    order = np.argsort(-scores, kind="stable")
    sv, si = live.retrieve_topk(q, 8, _score_fn(live, spec, params))
    assert not np.isin(si.numpy(), dead).any()
    np.testing.assert_array_equal(si.numpy(), order[:8])
    np.testing.assert_array_equal(sv.numpy(), scores[order[:8]])
    for bad in ([live.n_docs], [-1]):
        with pytest.raises(ValueError, match="out of range"):
            live.delete(bad)


def test_update_reassigns_ids(port):
    live = _mk_live(port, 1)
    (t0, s0), _ = _halves(port)
    n = live.n_docs
    np.testing.assert_array_equal(live.update([4], t0[:1], s0[:1]), [n])
    assert live.tombstones == 1 and live.n_docs == n + 1
    q = _q()
    m = live.qd_matrix(q, torch.tensor([4, 0, n], dtype=torch.int32))
    assert (m[0] == 0).all() and torch.equal(m[1], m[2])


# -- compaction ------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["none", "packed", "packed-q8"])
def test_compaction_is_invisible(port, codec):
    live = _mk_live(port, 2, codec=codec)
    live.delete([1, 7, live.n_docs - 2])
    q = _q()
    docs = torch.arange(-1, live.n_docs + 2, dtype=torch.int32)
    spec, params = _knrm(live)
    eng = SeineEngine(live, "knrm", params)
    m0 = live.qd_matrix(q, docs)
    r0 = eng.retrieve(q, 20)
    s0 = eng.score(q, docs.clamp(0, live.n_docs - 1))
    live.compact()
    assert live.generation == 1 and live.delta_nnz == 0
    assert live.codec == {"packed-q8": "packed"}.get(codec, codec)
    assert live.base.n_docs == live.n_docs
    assert torch.equal(live.qd_matrix(q, docs), m0)
    r1 = eng.retrieve(q, 20)
    assert torch.equal(r1[0], r0[0]) and torch.equal(r1[1], r0[1])
    assert torch.equal(eng.score(q, docs.clamp(0, live.n_docs - 1)), s0)
    # dead postings are gone from the new generation
    alive = live.view.alive.numpy()
    ids = live.base.doc_ids if live.codec == "none" else None
    if ids is not None:
        offs = live.base.term_offsets.numpy()
        for s in range(live.base.n_shards):
            assert alive[ids[s, :offs[s, -1]].numpy()].all()


def test_insert_after_compaction_matches_rebuild(port):
    live = _mk_live(port, 2)
    live.compact()
    (t0, s0), _ = _halves(port)
    live.insert(t0[:6], s0[:6])
    toks = np.concatenate([port["toks"], t0[:6]])
    segs = np.concatenate([port["segs"], s0[:6]])
    full = port["builder"].build_partitioned(toks, segs, 2, batch_size=16)
    q = _q()
    docs = torch.arange(full.n_docs, dtype=torch.int32)
    assert live.nnz == full.nnz and live.generation == 1
    assert torch.equal(live.qd_matrix(q, docs), full.qd_matrix(q, docs))


def test_background_compaction_and_stable_queries(port):
    """Readers running while a background compaction merges and swaps see
    the same bits before, during and after it; a failed compaction is
    counted and raised by wait_compaction."""
    live = _mk_live(port, 2)
    live.delete([3])
    q = _q()
    docs = torch.arange(live.n_docs, dtype=torch.int32)
    want = live.qd_matrix(q, docs)
    seen, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            seen.append(torch.equal(live.qd_matrix(q, docs), want))

    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in readers:
        t.start()
    thread = live.compact(wait=False)
    assert thread is not None
    live.wait_compaction()
    stop.set()
    for t in readers:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in readers)
    assert seen and all(seen)
    assert live.generation == 1
    assert torch.equal(live.qd_matrix(q, docs), want)
    obs.reset()
    live._pl = None                          # the next insert fails...
    live._base = None                        # ...and so does a compaction
    live.compact(wait=False)
    with pytest.raises(AttributeError):
        live.wait_compaction()
    assert obs.counter("seine_live_compaction_errors_total").get() == 1


def test_ckpt_dir_epoch_swap(port, tmp_path):
    d = str(tmp_path / "live")
    live = _mk_live(port, 2, ckpt_dir=d)
    live.delete([2])
    live.compact()
    saved = load_index(d, device="cpu")
    for f in ID_FIELDS + ("values",):
        assert torch.equal(getattr(saved, f), getattr(live.base, f)), f
    assert saved.n_docs == live.n_docs
    live.insert(port["toks"][:3], port["segs"][:3])
    live.compact()
    assert load_index(d, device="cpu").n_docs == live.n_docs
    assert sorted(p.name for p in tmp_path.iterdir()) == ["live"]


def test_found_counts_and_sampled_stats(live2, full2):
    q = _q()
    docs = torch.arange(full2.n_docs, dtype=torch.int32)
    spec, params = _knrm(full2)
    full_eng = SeineEngine(full2, "knrm", params)
    assert found_counts(live2.view, q, docs) == \
        full_eng._found_counts(q, docs)
    obs.reset()
    eng = SeineEngine(live2, "knrm", params)
    eng.score(q, docs)
    assert obs.counter("seine_lookup_found_total").get() == \
        found_counts(live2.view, q, docs)[0]
    assert obs.counter("seine_lookup_pairs_total").get(shard="0") > 0


def test_frontend_through_a_compaction(port):
    """Coalesced and cached front ends over a live index: every served
    score equals engine.score; a compaction between two waves raises
    the generation, and the cached front end rebinds its tile cache."""
    live = _mk_live(port, 2)
    live.delete([5])
    spec, params = _knrm(live)
    eng = SeineEngine(live, "knrm", params)
    rng = np.random.RandomState(2)
    reqs = [(rng.randint(-1, 60, 6).astype(np.int32),
             rng.randint(0, live.n_docs, 12).astype(np.int32))
            for _ in range(8)]
    want = [eng.score(q, d).numpy() for q, d in reqs]
    for kw in (dict(coalesce=True), dict(coalesce=True, cache_tiles=16)):
        with ServingFrontend(eng, max_batch=4, batch_timeout_ms=1,
                             **kw) as fe:
            for (q, d), w_ in zip(reqs, want):
                np.testing.assert_array_equal(
                    fe.submit(q, d).result(timeout=60), w_)
            epoch = fe.cache.epoch if fe.cache is not None else None
            gen = live.generation
            live.compact()
            assert live.generation == gen + 1
            for (q, d), w_ in zip(reqs, want):
                np.testing.assert_array_equal(
                    fe.submit(q, d).result(timeout=60), w_)
            if epoch is not None:
                assert fe.cache.epoch == epoch + 1
                assert fe.cache.index is live.base


def test_live_index_helper_and_guards(port):
    (t0, s0), (t1, s1) = _halves(port)
    live = live_index(port["builder"], t0, s0, 2, batch_size=16)
    assert live.n_docs == t0.shape[0] and live.n_shards == 2
    with pytest.raises(TypeError, match="PartitionedIndex"):
        LiveIndex(port["builder"].build(t0, s0), port["builder"].pipeline)
    with pytest.raises(ValueError, match="delta_shards"):
        LiveIndex(live.base, port["builder"].pipeline, delta_shards=0)
    with pytest.raises(ValueError, match="matching"):
        live.insert(t1, s1[:, :10])
    obs.reset()
    live.insert(t1[:4], s1[:4])
    live.delete([0])
    live.compact()
    assert obs.counter("seine_live_ingest_docs_total").get() == 4
    assert obs.counter("seine_live_deletes_total").get() == 1
    assert obs.counter("seine_live_compactions_total").get() == 1
    assert obs.gauge("seine_live_generation").get() == 1
    assert obs.gauge("seine_live_docs").get() == live.n_docs
    spans = obs.span_stats()
    assert "live.ingest" in spans and "live.compact" in spans
