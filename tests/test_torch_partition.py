"""PyTorch port of the partition planners and the stage-4 merger, held
bitwise against the JAX package on the CPU: plans, every array of
``partition_index`` and of ``partitioned_from_runs`` over several runs,
the merger's warnings, and the engine that partitions a raw index."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.build_pipeline import PostingRun as JaxRun
from repro.core.index import merge_run_parts as jax_merge_run_parts
from repro.data.synth_corpus import build_zipfian_index as jax_zipfian
from repro.dist.partition import partitioned_from_runs as jax_from_runs
from repro.dist.sharding import partition_index as jax_partition
from repro.dist.sharding import plan_posting_ranges as jax_plan_postings
from repro.dist.sharding import plan_term_ranges as jax_plan_terms
from repro.retrievers import get_retriever as jax_get
from repro.serving.engine import SeineEngine as JaxEngine
from repro_torch.convert import index_to_device, params_from_jax
from repro_torch.core.build_pipeline import PostingRun
from repro_torch.core.index import merge_run_parts
from repro_torch.dist.partition import (merged_term_counts,
                                        partitioned_from_runs)
from repro_torch.dist.sharding import (partition_index, plan_posting_ranges,
                                       plan_term_ranges)
from repro_torch.serving import SeineEngine
from torch_helpers import adversarial, assert_same_partition
import torch_threads  # noqa: F401  (PyTorch threads per test process)

K_PLAN = (1, 2, 3, 4, 8)
K_PART = (1, 2, 3, 4)


def _offsets(index):
    return np.asarray(index.term_offsets, np.int64)


@pytest.fixture(scope="module")
def ports(seine_world, hot_term_index):
    """The two corpora as the port's raw single-CSR indexes."""
    return {"world": (seine_world["index"],
                      index_to_device(seine_world["index"], device="cpu")),
            "hot": (hot_term_index,
                    index_to_device(hot_term_index, device="cpu"))}


@pytest.mark.parametrize("corpus", ["world", "hot"])
@pytest.mark.parametrize("k", K_PLAN)
def test_plans_match_jax(ports, corpus, k):
    offs = _offsets(ports[corpus][0])
    np.testing.assert_array_equal(plan_term_ranges(offs, k),
                                  jax_plan_terms(offs, k))
    got, want = plan_posting_ranges(offs, k), jax_plan_postings(offs, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    if corpus == "hot" and k >= 4:
        assert got[1].any(), "the hot term must be cut mid-list"


def test_plans_reject_bad_k_and_allow_empty_ranges():
    offs = np.array([0, 2, 2, 5], np.int64)
    for plan in (plan_term_ranges, plan_posting_ranges):
        with pytest.raises(ValueError, match="k >= 1"):
            plan(offs, 0)
    np.testing.assert_array_equal(plan_term_ranges(offs, 8),
                                  jax_plan_terms(offs, 8))
    for g, w in zip(plan_posting_ranges(offs, 8),
                    jax_plan_postings(offs, 8)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("corpus", ["world", "hot"])
@pytest.mark.parametrize("k", K_PART)
def test_partition_index_matches_jax(ports, corpus, k):
    """Every array of the K-shard partition equals the reference's, dtype
    included; the hot corpus splits its hot term at K = 4."""
    jax_idx, port = ports[corpus]
    ref = jax_partition(jax_idx, k)
    got = partition_index(port, k)
    assert_same_partition(got, ref)
    assert got.device == torch.device("cpu")
    if corpus == "hot" and k == 4:
        assert got.split_term is not None
    q, docs = np.array([0, 1, 3, -1, 17, 39], np.int32), np.arange(
        -2, jax_idx.n_docs + 2, dtype=np.int32)
    np.testing.assert_array_equal(
        got.qd_matrix(torch.from_numpy(q), torch.from_numpy(docs)).numpy(),
        np.asarray(ref.qd_matrix(jnp.asarray(q), jnp.asarray(docs))))


def test_skew_warning_without_split(ports):
    """split_hot=False: the unsplittable hot list pads every shard up to
    it, warned as the reference warns, and lookups stay exact."""
    jax_idx, port = ports["hot"]
    with pytest.warns(UserWarning, match="skewed posting lists"):
        ref = jax_partition(jax_idx, 8, split_hot=False)
    with pytest.warns(UserWarning, match="skewed posting lists"):
        got = partition_index(port, 8, split_hot=False)
    assert got.split_term is None
    assert_same_partition(got, ref)
    q = torch.tensor([0, 1, 17, -1], dtype=torch.int32)
    docs = torch.arange(0, jax_idx.n_docs, 7, dtype=torch.int32)
    np.testing.assert_array_equal(got.qd_matrix(q, docs).numpy(),
                                  port.qd_matrix(q, docs).numpy())


def _warned(fn):
    """(result, warning messages) of ``fn()``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in caught]


def test_k_beyond_populated_terms_clamps_with_a_warning():
    """Six shards over three populated terms: the merger clamps K with a
    warning (and, its one hot list unsplit, warns of the skew too)."""
    jax_idx = jax_zipfian(n_docs=16, vocab=3, min_tail=2)
    port = index_to_device(jax_idx, device="cpu")
    ref, want = _warned(lambda: jax_partition(jax_idx, 6, split_hot=False))
    got, msgs = _warned(lambda: partition_index(port, 6, split_hot=False))
    assert any("clamping to 3" in m for m in msgs)
    assert [m.split(":")[0] for m in msgs] == [m.split(":")[0] for m in want]
    assert got.n_shards == ref.n_shards == 3
    assert_same_partition(got, ref)


def _runs(index, n_runs, run_cls):
    """The index's postings as ``n_runs`` term-sorted runs, one per doc
    range, as the streaming build spills them."""
    offs = _offsets(index)
    terms = np.repeat(np.arange(len(offs) - 1, dtype=np.int32),
                      np.diff(offs))
    docs = np.asarray(index.doc_ids)
    vals = np.asarray(index.values)
    cuts = np.linspace(0, index.n_docs, n_runs + 1).astype(int)
    runs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        sel = np.flatnonzero((docs >= a) & (docs < b))
        runs.append(run_cls.from_arrays(terms[sel].copy(), docs[sel].copy(),
                                        vals[sel].copy()))
    return runs


@pytest.mark.parametrize("codec", ["none", "packed", "packed-q8"])
@pytest.mark.parametrize("k", (4, 8))
def test_partitioned_from_runs_matches_jax(hot_term_index, k, codec):
    """Three runs merged per shard (the lexsort path) and the hot term's
    doc ids merged across runs for its split, under every codec."""
    idx = hot_term_index
    static = dict(idf=np.asarray(idx.idf), doc_len=np.asarray(idx.doc_len),
                  seg_len=np.asarray(idx.seg_len), n_docs=idx.n_docs,
                  vocab_size=idx.vocab_size, n_b=idx.n_b,
                  functions=idx.functions, codec=codec, codec_tile=64)
    ref = jax_from_runs(_runs(idx, 3, JaxRun), k, **static)
    runs = _runs(idx, 3, PostingRun)
    np.testing.assert_array_equal(merged_term_counts(runs, idx.vocab_size),
                                  np.bincount(np.repeat(
                                      np.arange(idx.vocab_size),
                                      np.diff(_offsets(idx)))))
    got = partitioned_from_runs(runs, k, device="cpu", **static)
    assert got.split_term is not None
    assert_same_partition(got, ref)


def test_merge_run_parts_matches_jax(hot_term_index):
    runs = _runs(hot_term_index, 3, PostingRun)
    parts = []
    for r in runs:
        t, d, v = r.load()
        sel = (t >= 2) & (t < 30)
        parts.append((t[sel], d[sel], v[sel]))
    kw = dict(n_b=hot_term_index.n_b, n_f=len(hot_term_index.functions))
    for ps in (parts, parts[:1], []):
        for g, w in zip(merge_run_parts(ps, 2, 30, **kw),
                        jax_merge_run_parts(ps, 2, 30, **kw)):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    r = runs[0]
    assert r.n_rows == r.term_ids.shape[0]
    assert r.ids()[0] is r.term_ids
    assert r.nbytes == sum(a.nbytes for a in r.load())


def test_mesh_is_not_ported(ports):
    """``partition_index(mesh=)`` places the partition (a 1 x 1 gloo mesh
    here: every shard on the one rank, the same arrays as the mesh-less
    partition); a codec cannot be combined with a mesh, as in the
    reference."""
    from repro_torch.launch.mesh import make_host_mesh, release_world
    index = ports["world"][1]
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        placed = partition_index(index, 2, mesh=mesh)
        plain = partition_index(index, 2)
        assert (placed.placement.lo, placed.placement.hi) == (0, 2)
        assert placed.nnz == plain.nnz and placed.nbytes == plain.nbytes
        for n in ("term_offsets", "doc_ids", "values", "fences",
                  "term_to_shard", "range_lo", "range_hi"):
            assert torch.equal(getattr(placed, n), getattr(plain, n)), n
        with pytest.raises(ValueError, match="cannot be combined with a "
                           "mesh"):
            partition_index(index, 2, mesh=mesh, codec="packed")
    finally:
        release_world()


@pytest.mark.parametrize("k", (1, 2, 3))
def test_engine_partitions_a_raw_index(seine_world, ports, k):
    """``SeineEngine(partition="term", n_shards=K)`` over a raw index
    scores as the JAX engine does, and as the unpartitioned port."""
    jax_idx, port = ports["world"]
    jp = jax_get("knrm").init(jax.random.PRNGKey(0), jax_idx.n_b,
                              jax_idx.functions)
    jax_eng = JaxEngine(jax_idx, "knrm", jp, partition="term", n_shards=k)
    eng = SeineEngine(port, "knrm", params_from_jax("knrm", jp,
                                                    device="cpu"),
                      partition="term", n_shards=k)
    assert eng.index.n_shards == k
    raw = SeineEngine(port, "knrm", params_from_jax("knrm", jp,
                                                    device="cpu"))
    q, docs = adversarial(seine_world, k)
    got = eng.score(q, docs).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_eng.score(
        jnp.asarray(q), jnp.asarray(docs))), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got, raw.score(q, docs).numpy())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s, d = eng.retrieve(q, 10)
    js, jd = jax_eng.retrieve(jnp.asarray(q), 10)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
