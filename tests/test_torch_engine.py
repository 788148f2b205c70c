"""PyTorch port of the serving engine, held against the JAX engine on the
CPU: ``score`` for all nine retrievers (rtol 1e-5 / atol 1e-6, identical
ranking), first-stage ``retrieve`` (equal top-k ids, ties toward the
lower doc id, recall@10 = 1.0 against brute force, single- and
multi-block scans) and the serving loops."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synth_corpus import build_zipfian_index as jax_zipfian
from repro.dist.sharding import partition_index
from repro.retrievers import all_retrievers
from repro.retrievers import get_retriever as jax_get
from repro.serving.engine import SeineEngine as JaxEngine
from repro.serving.engine import serve_batches as jax_serve_batches
from repro_torch.convert import index_to_device, params_from_jax
from repro_torch.kernels.csr_lookup import csr_retrieve_topk
from repro_torch.serving import (SeineEngine, ServeStats, serve_batches,
                                 serve_retrieval)
from torch_helpers import adversarial, export, jax_layout
import torch_threads  # noqa: F401  (PyTorch threads per test process)

TOL = dict(rtol=1e-5, atol=1e-6)
LAYOUTS = ("single", "k2", "k4")


@pytest.fixture(scope="module")
def world_ports(seine_world, tmp_path_factory):
    """seine_world's index in every layout, exported by JAX save_index and
    loaded by the port."""
    return {name: export(jax_layout(seine_world["index"], k),
                         tmp_path_factory.mktemp(name))
            for name, k in zip(LAYOUTS, (1, 2, 4))}


@pytest.fixture(scope="module")
def small():
    """The 64-doc Zipfian corpus of tests/test_retrieval.py, plus its K=4
    doc-range sub-sharded partition."""
    idx = jax_zipfian(n_docs=64, vocab=40)
    p = partition_index(idx, 4)
    assert p.split_term is not None
    return {"single": idx, "hot_k4": p}


def _engines(name, jax_index, port_index, seed=0):
    jp = jax_get(name).init(jax.random.PRNGKey(seed), jax_index.n_b,
                            jax_index.functions)
    return (JaxEngine(jax_index, name, jp),
            SeineEngine(port_index, name, params_from_jax(name, jp,
                                                          device="cpu")))


@pytest.mark.parametrize("name", sorted(all_retrievers()))
def test_score_matches_jax_engine(seine_world, world_ports, name):
    """Every retriever, every layout: adversarial ids and the whole
    corpus score within tolerance and rank identically."""
    idx = seine_world["index"]
    jax_eng, _ = _engines(name, idx, world_ports["single"])
    q, docs = adversarial(seine_world, 0)
    all_docs = np.arange(idx.n_docs, dtype=np.int32)
    queries = [q] + [np.asarray(x, np.int32)
                     for x in seine_world["queries"][:2]]
    want = [np.asarray(jax_eng.score(jnp.asarray(qq), jnp.asarray(d)))
            for qq in queries for d in (docs, all_docs)]
    for layout in LAYOUTS:
        eng = SeineEngine(world_ports[layout], name, params_from_jax(
            name, jax_eng.params, device="cpu"))
        got = [eng.score(qq, d).numpy() for qq in queries
               for d in (docs, all_docs)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL,
                                       err_msg=f"{name} {layout}")
        for g, w in zip(got[1::2], want[1::2]):
            np.testing.assert_array_equal(np.argsort(-g, kind="stable"),
                                          np.argsort(-w, kind="stable"))


def _assert_ties_toward_lower_id(scores, ids):
    for i in range(len(scores) - 1):
        if scores[i] == scores[i + 1]:
            assert ids[i] < ids[i + 1], (i, scores, ids)


@pytest.mark.parametrize("name", ["knrm", "hint"])
@pytest.mark.parametrize("layout", ["single", "hot_k4"])
@pytest.mark.parametrize("doc_block", [None, 16])
def test_retrieve_matches_jax_and_brute_force(small, name, layout,
                                              doc_block):
    jax_eng, eng = _engines(name, small[layout],
                            index_to_device(small[layout], device="cpu"))
    for q in ((3, 0, -1, 7, 99, 5), (3, 7, -1, 12, -1, -1), (-1,) * 6):
        q = np.asarray(q, np.int32)
        js, ji = jax_eng.retrieve(jnp.asarray(q), 10, doc_block=doc_block)
        s, d = eng.retrieve(q, 10, doc_block=doc_block)
        np.testing.assert_array_equal(d.numpy(), np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
        _assert_ties_toward_lower_id(s.numpy(), d.numpy())
        brute = eng.score(q, np.arange(64, dtype=np.int32)).numpy()
        top = np.argsort(-brute, kind="stable")[:10]
        assert len(set(top) & set(d.numpy().tolist())) / 10 == 1.0


def test_retrieve_k_beyond_the_corpus(small):
    """The top-k scan pads past the corpus with -inf / -1; the engine trims k
    to n_docs, and the order matches the JAX engine's."""
    jax_eng, eng = _engines("knrm", small["hot_k4"],
                            index_to_device(small["hot_k4"], device="cpu"))
    q = np.asarray((3, 0, -1, 7, 99, 5), np.int32)
    s, d = eng.retrieve(q, 1000)
    js, ji = jax_eng.retrieve(jnp.asarray(q), 1000)
    assert d.shape == (64,)
    np.testing.assert_array_equal(d.numpy(), np.asarray(ji))
    p = eng.index

    def score_block(m, docs):
        return torch.zeros(docs.shape[0])

    s, d = csr_retrieve_topk(p.term_offsets, p.doc_ids, p.values,
                             p.term_to_shard, p.range_lo, p.range_hi,
                             torch.as_tensor(q), n_docs=64, k=70,
                             score_block_fn=score_block, doc_block=16)
    np.testing.assert_array_equal(d[:64].numpy(), np.arange(64))
    assert (d[64:] == -1).all() and torch.isinf(s[64:]).all()
    assert (s[64:] < 0).all() and (s[:64] == 0).all()


def test_serve_loops_match_engine_and_jax(small):
    jax_eng, eng = _engines("deeptilebars", small["single"],
                            index_to_device(small["single"], device="cpu"))
    rng = np.random.RandomState(0)
    q = np.asarray((3, 0, -1, 7, 99, 5), np.int32)
    requests = [(q, rng.randint(0, 64, size=n).astype(np.int32))
                for n in (5, 16, 0, 9)]
    got, stats = serve_batches(eng, requests, batch_pad=8)
    want, _ = jax_serve_batches(jax_eng, requests, batch_pad=8)
    assert stats.n_requests == 3 and got[2].shape == (0,)
    for g, w, (qq, d) in zip(got, want, requests):
        assert g.shape == d.shape
        np.testing.assert_allclose(g, w, **TOL)
        if d.size:
            # padding changes the batch shape, hence the summation order
            # of the scorer's matmuls: equal within tolerance, not bitwise
            np.testing.assert_allclose(g, eng.score(qq, d).numpy(), **TOL)
    hits, rstats = serve_retrieval(eng, [q, q[::-1]], 5)
    assert rstats.n_requests == 2
    for (s, d), qq in zip(hits, [q, q[::-1]]):
        es, ed = eng.retrieve(qq, 5)
        np.testing.assert_array_equal(d, ed.numpy())
        np.testing.assert_array_equal(s, es.numpy())
    with pytest.raises(ValueError, match="batch_pad"):
        serve_batches(eng, requests, batch_pad=-1)


def test_unported_engine_options_raise(small):
    port = index_to_device(small["single"], device="cpu")
    _, eng = _engines("knrm", small["single"], port)
    params = eng.params
    for kw, exc in ((dict(mesh=object()), NotImplementedError),
                    (dict(codec="packed"), ValueError),
                    (dict(codec="zstd"), ValueError),
                    (dict(partition="doc"), ValueError),
                    (dict(partition="term", n_shards=0), ValueError),
                    (dict(lookup_tile=0), ValueError)):
        with pytest.raises(exc):
            SeineEngine(port, "knrm", params, **kw)

    # a live index serves as it is: no partition=, no other codec
    from repro_torch.dist.live import LiveIndex
    live = LiveIndex(index_to_device(small["hot_k4"], device="cpu"), None)
    with pytest.raises(ValueError, match="already partitioned"):
        SeineEngine(live, "knrm", params, partition="term")
    with pytest.raises(ValueError, match="conflicts"):
        SeineEngine(live, "knrm", params, codec="packed")
    with pytest.raises(NotImplementedError, match="mesh"):
        SeineEngine(live, "knrm", params, mesh=object())
    with pytest.raises(ValueError, match="k must be positive"):
        eng.retrieve(np.zeros(6, np.int32), 0)
    # a partitioned index is served as it is, at any lookup tile, and a
    # raw one is partitioned on request
    hot = SeineEngine(index_to_device(small["hot_k4"], device="cpu"),
                      "knrm", params, partition="term", lookup_tile=4)
    q, d = np.asarray((0, 3, -1), np.int32), np.arange(64, dtype=np.int32)
    np.testing.assert_array_equal(hot.score(q, d).numpy(),
                                  eng.score(q, d).numpy())
    split = SeineEngine(port, "knrm", params, partition="term", n_shards=4)
    assert split.index.n_shards == 4
    np.testing.assert_array_equal(split.score(q, d).numpy(),
                                  eng.score(q, d).numpy())


def test_serve_stats_window_and_percentiles():
    st = ServeStats(window=4)
    assert st.p50_ms == 0.0
    for ms in (1.0, 2.0, 3.0, 4.0, 100.0):
        st.record(ms)
    assert st.n_requests == 5 and st.total_ms == 110.0
    assert st.ms_per_request == 22.0
    assert list(st.latencies_ms) == [2.0, 3.0, 4.0, 100.0]
    assert st.p50_ms == 3.5
    assert st.p95_ms == pytest.approx(np.percentile([2, 3, 4, 100], 95))
