"""PyTorch port of the offline build (corpus -> vocabulary -> TextTiling ->
interactions -> tf > sigma filter -> term-sorted runs -> stage-4 merge),
the No-Index engine and ``save_index``, held against the JAX package on
``seine_world`` (tests/conftest.py) on the CPU.

Bitwise: the corpus, vocabulary, segments and padded queries, stage-1
unique terms, run term/doc ids and run boundaries, and every id field of
the built index (single CSR and K in {1, 2, 4} partitions).  Values at
rtol 1e-4 / atol 1e-5 (tests/test_kernels.py's seg_interact bar; the
port reduces in another order, see tests/test_torch_seg_interact.py);
No-Index scores the same.  Within the port, the index equals the legacy
build bit for bit, spilled runs equal resident ones, and indexed M equals
on-the-fly M at atol 1e-5 (tests/test_seine_core.py's bar).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import load_index as jax_load_index
from repro.ckpt import save_index as jax_save_index
from repro.core.build_pipeline import make_unique_terms_fn as jax_uniq_fn
from repro.data.batching import candidates_for_query as jax_candidates
from repro.data.batching import pad_queries as jax_pad_queries
from repro.retrievers import get_retriever as jax_get
from repro.serving.engine import NoIndexEngine as JaxNoIndex
from repro_torch.ckpt import load_index, save_index
from repro_torch.configs import SEINE_LETOR, seine_smoke
from repro_torch.convert import (interaction_params_from_jax,
                                 params_from_jax, provider_from_numpy)
from repro_torch.core.build_pipeline import (PostingRun,
                                             make_unique_terms_fn)
from repro_torch.core.builder import IndexBuilder, unique_terms_host
from repro_torch.core.providers import HashProvider, make_provider
from repro_torch.core.segment import segment_corpus
from repro_torch.core.vocab import build_vocabulary
from repro_torch.data.batching import (PairSampler, candidates_for_query,
                                       pad_queries)
from repro_torch.data.synth_corpus import generate
from repro_torch.serving import NoIndexEngine, SeineEngine
from torch_helpers import adversarial
import torch_threads  # noqa: F401  (PyTorch threads per test process)

TOL = dict(rtol=1e-4, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ID_FIELDS = ("term_offsets", "doc_ids", "fences", "term_to_shard",
             "range_lo", "range_hi", "split_term", "split_doc", "idf",
             "doc_len", "seg_len")
RETRIEVERS = ("knrm", "deeptilebars", "hint", "deepimpact")


def _port_world(seine_world):
    """The port's corpus pipeline on the same seed, and a builder over
    the JAX provider's table and interaction parameters."""
    w = seine_world
    cfg = seine_smoke()
    ds = generate(cfg, seed=0)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens,
                             keep_frac=cfg.vocab_keep_frac)
    toks, segs = segment_corpus([vocab.map_tokens(d) for d in ds.docs],
                                cfg.n_segments, max_len=160,
                                window=cfg.tile_window,
                                smooth=cfg.tile_smooth)
    provider = provider_from_numpy(np.asarray(w["provider"].table()),
                                   device="cpu")
    ip = interaction_params_from_jax(w["builder"].ip, device="cpu")
    builder = IndexBuilder(cfg, vocab, provider, ip=ip, device="cpu")
    index = builder.build(toks, segs, batch_size=16)
    return dict(cfg=cfg, ds=ds, vocab=vocab, toks=toks, segs=segs,
                provider=provider, ip=ip, builder=builder, index=index)


@pytest.fixture(scope="module")
def port(seine_world):
    return _port_world(seine_world)


def _values_close(got, want, names):
    got, want = np.asarray(got), np.asarray(want)
    for f, name in enumerate(names):
        if name in ("tf", "idf_indicator"):
            np.testing.assert_array_equal(got[..., f], want[..., f], name)
        else:
            np.testing.assert_allclose(got[..., f], want[..., f], **TOL,
                                       err_msg=name)


# -- the corpus side: host numpy, bitwise ---------------------------------

def test_config_copies_match_jax():
    from repro.configs import SEINE_LETOR as JAX_LETOR
    from repro.configs import seine_smoke as jax_smoke
    assert SEINE_LETOR == type(SEINE_LETOR)(**vars(JAX_LETOR))
    assert seine_smoke() == type(SEINE_LETOR)(**vars(jax_smoke()))


@pytest.mark.parametrize("seed", [0, 3])
def test_corpus_vocabulary_and_segments_match_jax(seine_world, seed):
    from repro.configs import seine_smoke as jax_smoke
    from repro.core import build_vocabulary as jax_vocab
    from repro.core import segment_corpus as jax_segment
    from repro.data.synth_corpus import generate as jax_generate
    cfg = seine_smoke()
    ds, want = generate(cfg, seed=seed), jax_generate(jax_smoke(), seed=seed)
    assert len(ds.docs) == len(want.docs) == cfg.n_docs
    for a, b in zip(ds.docs + ds.queries, want.docs + want.queries):
        np.testing.assert_array_equal(a, b)
    for n in ("qrels", "doc_topics", "query_topics"):
        np.testing.assert_array_equal(getattr(ds, n), getattr(want, n))
    assert ds.n_raw_tokens == want.n_raw_tokens
    for (tr, te), (wtr, wte) in zip(ds.folds(5, seed), want.folds(5, seed)):
        np.testing.assert_array_equal(tr, wtr)
        np.testing.assert_array_equal(te, wte)
    v = build_vocabulary(ds.docs, ds.n_raw_tokens)
    wv = jax_vocab(want.docs, want.n_raw_tokens)
    for n in ("raw_to_slot", "slot_to_raw", "idf"):
        np.testing.assert_array_equal(getattr(v, n), getattr(wv, n))
        assert getattr(v, n).dtype == getattr(wv, n).dtype
    slot = [v.map_tokens(d) for d in ds.docs]
    for n_b, max_len in ((5, 160), (3, 40)):
        got = segment_corpus(slot, n_b, max_len=max_len)
        ref = jax_segment(slot, n_b, max_len=max_len)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        pad_queries(ds.queries, v.map_tokens, q_len=6),
        jax_pad_queries(want.queries, wv.map_tokens, q_len=6))


def test_world_matches_jax(seine_world, port):
    for n in ("toks", "segs"):
        np.testing.assert_array_equal(port[n], seine_world[n])
    np.testing.assert_array_equal(
        pad_queries(port["ds"].queries, port["vocab"].map_tokens, q_len=6),
        seine_world["queries"])


def test_samplers_match_jax(seine_world):
    from repro.data.batching import PairSampler as JaxSampler
    qrels = seine_world["ds"].qrels
    ids = np.arange(qrels.shape[0])
    a, b = PairSampler(qrels, ids, 8, seed=2), JaxSampler(qrels, ids, 8,
                                                          seed=2)
    for _ in range(3):
        got, want = a.next_batch(), b.next_batch()
        for n in ("query", "pos", "neg"):
            np.testing.assert_array_equal(got[n], want[n])
    assert a.state_dict() == b.state_dict()
    np.testing.assert_array_equal(
        candidates_for_query(qrels[1], np.random.RandomState(4), 50),
        jax_candidates(qrels[1], np.random.RandomState(4), 50))


# -- stages 1-3 ------------------------------------------------------------

@pytest.mark.parametrize("max_uniq", [4, 32, 512])
def test_unique_terms_match_jax_and_numpy(seine_world, max_uniq):
    toks = seine_world["toks"][:16].copy()
    toks[3] = -1                                   # an all-pad doc
    want = np.asarray(jax_uniq_fn(max_uniq)(jnp.asarray(toks)))
    got = make_unique_terms_fn(max_uniq)(torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, unique_terms_host(toks, max_uniq))


@pytest.mark.parametrize("batch_size", [7, 16])
def test_stream_runs_match_jax(seine_world, port, batch_size):
    """Run by run: term ids, doc ids and the run boundaries bitwise
    (the last batch padded), values at the bar; ``doc_start`` offsets
    every doc id."""
    w = seine_world
    spiller, stats = w["builder"]._pipeline().stream_runs(
        w["toks"], w["segs"], batch_size=batch_size)
    mine, st = port["builder"].pipeline.stream_runs(
        port["toks"], port["segs"], batch_size=batch_size, doc_start=100)
    assert [r.n_rows for r in mine.runs] == [r.n_rows for r in spiller.runs]
    assert st.n_batches == stats.n_batches == len(spiller.runs)
    assert st.total_nnz == stats.total_nnz
    assert st.run_bytes == stats.run_bytes
    assert set(st.stage_s) == {"stage1_uniq", "stage2_interact",
                               "stage2b_compact", "stage3_spill"}
    for r, want in zip(mine.runs, spiller.runs):
        t, d, v = r.load()
        wt, wd, wv = want.load()
        np.testing.assert_array_equal(t, wt)
        np.testing.assert_array_equal(d - 100, wd)
        assert t.dtype == wt.dtype and d.dtype == wd.dtype
        _values_close(v, wv, w["builder"].functions)


def test_spilled_runs_equal_resident(port, tmp_path):
    pipe = port["builder"].pipeline
    res, _ = pipe.stream_runs(port["toks"], port["segs"], batch_size=16)
    spill, stats = pipe.stream_runs(port["toks"], port["segs"],
                                    batch_size=16, spill_dir=str(tmp_path))
    assert stats.spilled_bytes == sum(stats.run_bytes)
    assert stats.peak_host_bytes == max(stats.run_bytes)
    for a, b in zip(res.runs, spill.runs):
        assert b.term_ids is None and os.path.exists(b.path)
        for x, y in zip(a.load(), b.load()):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(a.ids(), b.ids()):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.term_counts(port["vocab"].size),
                                      b.term_counts(port["vocab"].size))
    idx = port["builder"].build(port["toks"], port["segs"], batch_size=16,
                                spill_dir=str(tmp_path / "b"))
    for n in ("term_offsets", "doc_ids", "values", "fences"):
        assert torch.equal(getattr(idx, n), getattr(port["index"], n)), n
    k4 = port["builder"].build_partitioned(
        port["toks"], port["segs"], 4, batch_size=16,
        spill_dir=str(tmp_path / "k4"))
    ref = port["builder"].build_partitioned(port["toks"], port["segs"], 4,
                                            batch_size=16)
    for n in ("term_offsets", "doc_ids", "values", "term_to_shard"):
        assert torch.equal(getattr(k4, n), getattr(ref, n)), n


def test_posting_run_from_arrays_counts_bytes():
    t = np.array([0, 0, 2], np.int32)
    d = np.array([1, 3, 0], np.int32)
    v = np.zeros((3, 2, 1), np.float32)
    run = PostingRun.from_arrays(t, d, v)
    assert run.n_rows == 3 and run.nbytes == 12 + 12 + 24
    np.testing.assert_array_equal(run.term_counts(4), [2, 0, 1, 0])


# -- stage 4: the built index ----------------------------------------------

def test_build_matches_jax_index(seine_world, port):
    idx, want = port["index"], seine_world["index"]
    for n in ("term_offsets", "doc_ids", "fences", "idf", "doc_len",
              "seg_len"):
        got, ref = getattr(idx, n).numpy(), np.asarray(getattr(want, n))
        assert got.dtype == ref.dtype, n
        np.testing.assert_array_equal(got, ref, err_msg=n)
    for n in ("n_docs", "vocab_size", "n_b", "functions"):
        assert getattr(idx, n) == getattr(want, n)
    _values_close(idx.values, want.values, want.functions)
    st = port["builder"].last_build_stats
    assert st.n_docs == idx.n_docs and st.total_nnz == idx.nnz
    assert "stage4_merge" in st.stage_s


def test_build_equals_legacy_within_the_port(port):
    legacy = port["builder"].build_legacy(port["toks"], port["segs"],
                                          batch_size=16)
    for n in ("term_offsets", "doc_ids", "values", "fences", "idf",
              "doc_len", "seg_len"):
        assert torch.equal(getattr(legacy, n), getattr(port["index"], n)), n


@pytest.mark.parametrize("k", [1, 2, 4])
def test_build_partitioned_matches_jax(seine_world, port, k):
    want = seine_world["builder"].build_partitioned(
        seine_world["toks"], seine_world["segs"], k, batch_size=16)
    got = port["builder"].build_partitioned(port["toks"], port["segs"], k,
                                            batch_size=16)
    for n in ID_FIELDS:
        w = getattr(want, n)
        if w is None:
            assert getattr(got, n) is None, n
            continue
        np.testing.assert_array_equal(getattr(got, n).numpy(),
                                      np.asarray(w), err_msg=n)
    assert got.n_shards == want.n_shards and got.codec == "none"
    _values_close(got.values, want.values, want.functions)


def test_build_partitioned_with_a_codec(port):
    got = port["builder"].build_partitioned(port["toks"], port["segs"], 2,
                                            batch_size=16, codec="packed",
                                            codec_tile=64)
    raw = port["builder"].build_partitioned(port["toks"], port["segs"], 2,
                                            batch_size=16)
    q = torch.from_numpy(seine_world_queries(port)[0])
    docs = torch.arange(port["index"].n_docs, dtype=torch.int32)
    assert got.codec == "packed" and got.codec_tile == 64
    assert torch.equal(got.qd_matrix(q, docs), raw.qd_matrix(q, docs))
    # on a mesh (1 x 1, gloo) the build runs and is the mesh-less one;
    # a codec cannot be combined with a mesh, as in the reference
    from repro_torch.launch.mesh import make_host_mesh, release_world
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        placed = port["builder"].build_partitioned(
            port["toks"], port["segs"], 2, batch_size=16, mesh=mesh)
        assert placed.placement.mesh is mesh
        for n in ("term_offsets", "doc_ids", "values", "fences",
                  "term_to_shard", "range_lo", "range_hi"):
            assert torch.equal(getattr(placed, n), getattr(raw, n)), n
        assert torch.equal(placed.qd_matrix(q, docs), raw.qd_matrix(q, docs))
        with pytest.raises(ValueError, match="mesh"):
            port["builder"].build_partitioned(port["toks"], port["segs"], 2,
                                              codec="packed", mesh=mesh)
    finally:
        release_world()


def seine_world_queries(port):
    return pad_queries(port["ds"].queries, port["vocab"].map_tokens,
                       q_len=6)


# -- on-the-fly (No-Index) against indexed and against JAX -----------------

def test_indexed_equals_on_the_fly(port):
    """The paper's invariant within the port: for stored pairs of eight
    docs, the built index's M equals M recomputed by make_qd_fn."""
    qd_fn = port["builder"].make_qd_fn()
    idx = port["index"]
    rng = np.random.RandomState(1)
    toks, segs = port["toks"], port["segs"]
    for d in rng.choice(toks.shape[0], 8, replace=False):
        present = np.unique(toks[d][toks[d] >= 0])
        q = np.full(6, -1, np.int32)
        sel = rng.choice(present, size=min(4, present.size), replace=False)
        q[:sel.size] = sel
        q[5] = idx.vocab_size + 2                 # past the vocabulary
        on_fly = qd_fn(torch.from_numpy(q), torch.from_numpy(toks[d:d + 1]),
                       torch.from_numpy(segs[d:d + 1]))[0]
        looked = idx.qd_matrix(torch.from_numpy(q),
                               torch.tensor([int(d)], dtype=torch.int32))[0]
        np.testing.assert_allclose(looked.numpy(), on_fly.numpy(),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", RETRIEVERS)
def test_noindex_engine_matches_jax(seine_world, port, name):
    """Adversarial ids (past-vocab and OOV terms, negative and
    past-the-end docs) through both No-Index engines, and the port's
    No-Index against its indexed engine on in-range docs."""
    w = seine_world
    jp = jax_get(name).init(jax.random.PRNGKey(0), w["index"].n_b,
                            w["index"].functions)
    want_eng = JaxNoIndex(w["builder"], w["index"], w["toks"], w["segs"],
                          name, jp)
    params = params_from_jax(name, jp, device="cpu")
    eng = NoIndexEngine(port["builder"], port["index"], port["toks"],
                        port["segs"], name, params)
    indexed = SeineEngine(port["index"], name, params)
    for seed in range(3):
        q, docs = adversarial(w, seed)
        got = eng.score(q, docs).numpy()
        want = np.asarray(want_eng.score(jnp.asarray(q), jnp.asarray(docs)))
        np.testing.assert_allclose(got, want, **TOL)
        ok = (docs >= 0) & (docs < w["index"].n_docs)
        np.testing.assert_allclose(got[ok], indexed.score(q, docs).numpy()
                                   [ok], **TOL)


# -- checkpoints, both directions -------------------------------------------

def _same_index_arrays(got, want):
    names = ("term_offsets", "doc_ids", "values", "fences", "idf",
             "doc_len", "seg_len")
    if hasattr(want, "term_to_shard"):
        names += ("term_to_shard", "range_lo", "range_hi", "split_term",
                  "split_doc")
    for n in names:
        a, b = getattr(got, n), getattr(want, n)
        if b is None:
            assert a is None, n
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=n)
    for n in ("n_docs", "vocab_size", "n_b", "functions"):
        assert tuple(np.atleast_1d(getattr(got, n))) == tuple(
            np.atleast_1d(getattr(want, n))), n


@pytest.mark.parametrize("k", [1, 4])
def test_save_index_is_read_by_jax_and_back(port, tmp_path, k):
    idx = port["index"] if k == 1 else port["builder"].build_partitioned(
        port["toks"], port["segs"], k, batch_size=16)
    path = save_index(str(tmp_path / "idx"), idx)
    with open(os.path.join(path, "index_manifest.json")) as f:
        assert json.load(f)["kind"] == ("segment" if k == 1
                                        else "partitioned")
    _same_index_arrays(jax_load_index(path), idx)
    _same_index_arrays(load_index(path, device="cpu"), idx)
    # JAX writes what JAX read; the port reads it back unchanged
    jax_save_index(str(tmp_path / "jax"), jax_load_index(path))
    _same_index_arrays(load_index(str(tmp_path / "jax"), device="cpu"), idx)


def test_save_index_overwrites_by_moving_aside(port, tmp_path):
    path = str(tmp_path / "idx")
    save_index(path, port["index"])
    os.makedirs(path + ".old999")
    os.makedirs(path + ".tmp999")
    small = port["builder"].build(port["toks"][:20], port["segs"][:20],
                                  batch_size=16)
    save_index(path, small)
    assert not os.path.exists(path + ".old999")
    assert not os.path.exists(path + ".tmp999")
    assert load_index(path, device="cpu").n_docs == 20
    with pytest.raises(TypeError, match="cannot save"):
        save_index(str(tmp_path / "x"), object())


def test_packed_save_index_is_read_by_jax(port, tmp_path):
    pidx = port["builder"].build_partitioned(
        port["toks"], port["segs"], 2, batch_size=16, codec="packed-q8",
        codec_tile=64)
    path = save_index(str(tmp_path / "q8"), pidx)
    got = jax_load_index(path)
    assert got.codec == "packed-q8" and got.codec_tile == 64
    for n in ("packed_words", "tile_bits", "tile_base", "tile_word_off",
              "values_q", "value_scale", "term_offsets", "fences"):
        np.testing.assert_array_equal(np.asarray(getattr(got, n)),
                                      getattr(pidx, n).numpy(), err_msg=n)


# -- providers and device policy ---------------------------------------------

def test_providers(port):
    gen = torch.Generator().manual_seed(5)
    p = make_provider("hash", 50, 8, generator=gen, device="cpu")
    assert p.table().shape == (50, 8)
    again = make_provider("hash", 50, 8, seed=5, device="cpu")
    assert torch.equal(p.table(), again.table())
    learned = make_provider("learned", 50, 8, seed=5, device="cpu")
    assert torch.equal(learned.table(), p.table())
    assert learned.with_table(learned.table() * 2).alpha == learned.alpha
    with pytest.raises(ValueError, match="unknown provider"):
        make_provider("lm", 50, 8, device="cpu")
    with pytest.raises(ValueError, match="table must be"):
        HashProvider(4, 8, table=torch.zeros(3, 8), device="cpu")
    # a batch of docs contextualises as each doc alone
    toks = torch.from_numpy(port["toks"][:4])
    segs = torch.from_numpy(port["segs"][:4])
    prov = port["provider"]
    both = prov.contextualize(toks, segs)
    for i in range(4):
        torch.testing.assert_close(both[i], prov.contextualize(toks[i],
                                                               segs[i]))


def test_contextualize_matches_jax(seine_world, port):
    w = seine_world
    for d in (0, 7, 31):
        want = np.asarray(w["provider"].contextualize(
            jnp.asarray(w["toks"][d]), jnp.asarray(w["segs"][d])))
        got = port["provider"].contextualize(
            torch.from_numpy(port["toks"][d]),
            torch.from_numpy(port["segs"][d])).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_build_entry_points_default_to_cuda(port, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IndexBuilder(port["cfg"], port["vocab"], port["provider"],
                     ip=port["ip"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HashProvider(10, 4)
    with pytest.raises(ValueError, match="provider's table"):
        from repro_torch.core.builder import make_batch_interaction_fn
        make_batch_interaction_fn(port["provider"], torch.zeros(3), port["ip"],
                                  5, ("tf",), device="meta")


def test_readme_build_recipe_runs():
    """The README's recipe for building an index with the port runs as
    written (on the CPU here)."""
    with open(os.path.join(REPO, "README.md")) as f:
        blocks = f.read().split("```python\n")[1:]
    code = next(b.split("```")[0] for b in blocks
                if "repro_torch.core.builder" in b)
    env = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
               PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "shards=2" in r.stdout
