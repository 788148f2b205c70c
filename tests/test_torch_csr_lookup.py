"""PyTorch port of the serving lookup and the first-stage scan, held
bitwise (rtol=0/atol=0) against the JAX package on the CPU.

Oracles: the single-CSR composition ``qd_matrix(impl="jnp")`` and the
JAX ops' default CPU lowering (``csr_lookup_ref``, ``retrieve_block_ref``)
— never the Pallas interpreter.  Both port paths are held: the torch ref
lowering (``impl=None`` on the CPU) and the kernel's dataflow
(``impl="kernel"``: routing, fence rebuild, and the kernel's plain
per-cell version ``csr_lookup_plain``).  The CUDA kernels themselves are
held against those plain versions in tests/test_torch_gpu.py.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.csr_lookup import csr_lookup as jax_csr_lookup
from repro.kernels.csr_lookup import csr_retrieve_block as jax_retrieve
from repro.kernels.csr_lookup import lookup_pairs_ref as jax_pairs_ref
from repro_torch.kernels.csr_lookup import (csr_lookup, csr_lookup_kernel,
                                            csr_lookup_plain, csr_lookup_ref,
                                            csr_retrieve_block,
                                            lookup_pairs_ref,
                                            retrieve_block_ref,
                                            route_pairs, route_terms)
from repro_torch.kernels.csr_lookup.kernel import (FENCE_SEARCH, ID_SEARCH,
                                                   WHOLE_RANGE)
from repro_torch.kernels.utils import SOURCES
from torch_helpers import (K_SWEEP, TILE_SWEEP, adversarial, export,
                           jax_layout, t)
import torch_threads  # noqa: F401  (PyTorch threads per test process)

QUERY = (3, 0, -1, 7, 99, 5)


@pytest.fixture(scope="module")
def world_layouts(seine_world, tmp_path_factory):
    """{K: (jax index, port index)} of seine_world at every K."""
    out = {}
    for k in K_SWEEP:
        ref = jax_layout(seine_world["index"], k)
        out[k] = (ref, export(ref, tmp_path_factory.mktemp(f"k{k}")))
    return out


@pytest.fixture(scope="module")
def hot_layouts(hot_term_index, tmp_path_factory):
    """{K: (jax, port)} of the hot-term corpus, sub-sharded at K >= 4."""
    from repro.dist.sharding import partition_index
    out = {}
    for k in (4, 8):
        ref = partition_index(hot_term_index, k)
        assert ref.split_term is not None, "corpus must trigger sub-sharding"
        out[k] = (ref, export(ref, tmp_path_factory.mktemp(f"hot{k}")))
    return out


def _stacked(idx):
    """The port index's arrays in the ops' K-stacked argument order."""
    if hasattr(idx, "term_to_shard"):
        return (idx.term_offsets, idx.doc_ids, idx.values,
                idx.term_to_shard, idx.range_lo)
    return (idx.term_offsets[None], idx.doc_ids[None], idx.values[None],
            None, None)


@pytest.mark.parametrize("impl", [None, "kernel"])
@pytest.mark.parametrize("tile", TILE_SWEEP)
@pytest.mark.parametrize("k", K_SWEEP)
def test_qd_matrix_bitwise(seine_world, world_layouts, k, tile, impl):
    """M over the adversarial ids equals the JAX single-CSR oracle and
    the JAX CPU lowering bit for bit, for both port paths at every tile
    width and shard count; the per-cell kernel mirror equals the ref."""
    jax_idx, port = world_layouts[k]
    for seed in range(2):
        q, docs = adversarial(seine_world, seed)
        oracle = np.asarray(seine_world["index"].qd_matrix(
            jnp.asarray(q), jnp.asarray(docs), impl="jnp"))
        jax_ref = np.asarray(jax_idx.qd_matrix(jnp.asarray(q),
                                               jnp.asarray(docs)))
        got = port.qd_matrix(t(q), t(docs), impl=impl, tile=tile).numpy()
        np.testing.assert_array_equal(got, oracle, err_msg=f"seed={seed}")
        np.testing.assert_array_equal(got, jax_ref, err_msg=f"seed={seed}")
        assert np.array_equal(np.signbit(got), np.signbit(jax_ref))


@pytest.mark.parametrize("impl", [None, "kernel"])
@pytest.mark.parametrize("k", (4, 8))
def test_sub_sharded_hot_term_bitwise(hot_term_index, hot_layouts, k, impl):
    """Per-pair routing: doc ids straddling every sub-shard boundary."""
    jax_idx, port = hot_layouts[k]
    splits = port.split_doc.numpy()[port.split_term.numpy() >= 0]
    q = np.array([0, 1, 17, -1, hot_term_index.vocab_size + 3, 39],
                 np.int32)
    docs = np.concatenate([splits, splits - 1,
                           [0, hot_term_index.n_docs - 1,
                            hot_term_index.n_docs, -3]]).astype(np.int32)
    oracle = np.asarray(hot_term_index.qd_matrix(jnp.asarray(q),
                                                 jnp.asarray(docs),
                                                 impl="jnp"))
    for tile in TILE_SWEEP + (4,):
        got = port.qd_matrix(t(q), t(docs), impl=impl, tile=tile).numpy()
        np.testing.assert_array_equal(got, oracle, err_msg=f"tile={tile}")


@pytest.mark.parametrize("k", K_SWEEP)
def test_routing_and_lookup_pairs_bitwise(seine_world, world_layouts, k):
    """Routing tables and the generic-batch pair lookup."""
    from repro.kernels.csr_lookup import route_terms as jax_route_terms
    jax_idx, port = world_layouts[k]
    q, docs = adversarial(seine_world, 7)
    to, dids, vals, t2s, rlo = _stacked(port)
    jarr = [jnp.asarray(a.numpy()) if a is not None else None
            for a in (to, t2s, rlo)]
    for got, want in zip(route_terms(t(q), to, t2s, rlo),
                         jax_route_terms(jnp.asarray(q), *jarr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    terms = np.broadcast_to(q, (docs.size, q.size)).copy()
    got = lookup_pairs_ref(to, dids, vals, t2s, rlo, t(terms), t(docs))
    want = jax_pairs_ref(*[jnp.asarray(a.numpy()) if a is not None else None
                           for a in (to, dids, vals, t2s, rlo)],
                         jnp.asarray(terms), jnp.asarray(docs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if k == 1:
        got = port.lookup_pairs(t(terms), t(docs))
        want = seine_world["index"].lookup_pairs(jnp.asarray(terms),
                                                 jnp.asarray(docs))
    else:
        got = port.lookup_pairs(t(terms), t(docs))
        want = jax_idx.lookup_pairs(jnp.asarray(terms), jnp.asarray(docs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_route_pairs_matches_jax(hot_layouts):
    from repro.kernels.csr_lookup import route_pairs as jax_route_pairs
    _, port = hot_layouts[8]
    w = np.array([[0, 0, 1, -1], [0, 5, 39, 60]], np.int32)
    d = np.array([[0, 63, 20, 5], [31, 8, 2, 1]], np.int32)
    args = (port.term_offsets, port.term_to_shard, port.range_lo,
            port.split_term, port.split_doc)
    got = route_pairs(t(w), t(d), *args)
    want = jax_route_pairs(jnp.asarray(w), jnp.asarray(d),
                           *[jnp.asarray(a.numpy()) for a in args])
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("k", K_SWEEP)
@pytest.mark.parametrize("block,blo", [(64, 0), (16, 16), (16, 48),
                                       (100, 0)])
def test_retrieve_block_bitwise(hot_term_index, k, block, blo):
    """Scanned M blocks equal the JAX scan (bit for bit, sign of zero
    included) and the lookup's M (rtol=0/atol=0), for the ref and the
    fused kernel's plain version."""
    from repro.dist.sharding import partition_index
    from repro_torch.convert import index_to_device
    small = hot_term_index
    ref = small if k == 1 else partition_index(small, k)
    port = index_to_device(ref, device="cpu")
    q = np.asarray(QUERY, np.int32)
    rng_hi = None if k == 1 else port.range_hi
    to, dids, vals, t2s, rlo = _stacked(port)
    jargs = [jnp.asarray(a.numpy()) if a is not None else None
             for a in (to, dids, vals, t2s, rlo, rng_hi)]
    want = np.asarray(jax_retrieve(*jargs, jnp.asarray(q), blo, block=block))
    lookup = np.asarray(small.qd_matrix(
        jnp.asarray(q), jnp.arange(small.n_docs, dtype=jnp.int32)))
    for impl in (None, "kernel"):
        got = csr_retrieve_block(to, dids, vals, t2s, rlo, rng_hi, t(q), blo,
                                 block=block, impl=impl).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"impl={impl}")
        assert np.array_equal(np.signbit(got), np.signbit(want))
        n = max(0, min(block, small.n_docs - blo))
        np.testing.assert_allclose(got[:n], lookup[blo:blo + n], rtol=0,
                                   atol=0)
        assert not got[n:].any()
    np.testing.assert_array_equal(
        retrieve_block_ref(to, dids, vals, t2s, rlo, rng_hi, t(q), blo,
                           block).numpy(), want)


@pytest.mark.parametrize("k", (1, 4))
def test_tombstones_match_jax(hot_term_index, k):
    """``alive`` zeroes dead docs' pairs on the lookup and the scan."""
    from repro.dist.sharding import partition_index
    from repro_torch.convert import index_to_device
    ref = hot_term_index if k == 1 else partition_index(hot_term_index, k)
    port = index_to_device(ref, device="cpu")
    alive = np.random.RandomState(3).rand(hot_term_index.n_docs) > 0.3
    q = np.asarray(QUERY, np.int32)
    docs = np.array([0, 1, 2, 5, 17, 63, 64, -1], np.int32)
    args = _stacked(port)
    jargs = [jnp.asarray(a.numpy()) if a is not None else None for a in args]
    split = {} if k == 1 else dict(split_term=port.split_term,
                                   split_doc=port.split_doc)
    jsplit = {n: jnp.asarray(v.numpy()) for n, v in split.items()}
    want = np.asarray(jax_csr_lookup(*jargs, jnp.asarray(q),
                                     jnp.asarray(docs),
                                     alive=jnp.asarray(alive), **jsplit))
    rng_hi = None if k == 1 else port.range_hi
    want_b = np.asarray(jax_retrieve(
        *jargs, None if rng_hi is None else jnp.asarray(rng_hi.numpy()),
        jnp.asarray(q), 0, block=64, alive=jnp.asarray(alive)))
    for impl in (None, "kernel"):
        got = csr_lookup(*args, t(q), t(docs), impl=impl,
                         alive=torch.from_numpy(alive), **split)
        np.testing.assert_array_equal(got.numpy(), want)
        got_b = csr_retrieve_block(*args, rng_hi, t(q), 0, block=64,
                                   impl=impl, alive=torch.from_numpy(alive))
        np.testing.assert_array_equal(got_b.numpy(), want_b)


def test_plain_kernel_version_matches_ref_per_term_and_per_pair(
        hot_layouts):
    """The kernel wrapper's plain version, fed routing of both ranks,
    equals the ref lowering — the contract the CUDA kernel is held to."""
    from repro_torch.core.index import build_fences
    _, port = hot_layouts[4]
    q = t([0, 1, 17, -1, 45, 39, 3])
    docs = t(np.r_[np.arange(-1, 66), [0, 0]])
    shape = (q.shape[0], docs.shape[0])
    k, lo, hi = route_pairs(q[:, None].expand(shape),
                            docs[None].expand(shape), port.term_offsets,
                            port.term_to_shard, port.range_lo,
                            port.split_term, port.split_doc)
    want = csr_lookup_ref(port.term_offsets, port.doc_ids, port.values,
                          port.term_to_shard, port.range_lo, q, docs,
                          port.split_term, port.split_doc)
    for tile in (2, 16, 256):
        fences = build_fences(port.doc_ids, tile)
        got = csr_lookup_kernel(k, lo, hi, docs, port.doc_ids, fences,
                                port.values, tile=tile)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    k1, lo1, hi1 = route_terms(q, port.term_offsets, port.term_to_shard,
                               port.range_lo)
    got = csr_lookup_plain(k1, lo1, hi1, docs, port.doc_ids,
                           build_fences(port.doc_ids, 8), port.values,
                           tile=8)
    want = csr_lookup_ref(port.term_offsets, port.doc_ids, port.values,
                          port.term_to_shard, port.range_lo, q, docs)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# one hot term in all 20,402 docs and 39 tail terms: 20,480 postings, a
# multiple of every tile below, so the last term's range and the K = 4
# shards (5,120 postings each, the hot term split over all four) end at
# tile-aligned shard ends; the hot term's ranges are longer than the
# kernel searches without its fences
DEEP_DOCS = 20402


@pytest.fixture(scope="module")
def deep_layouts(seine_world, world_layouts, tmp_path_factory):
    """{(world, K): (JAX single-CSR oracle, JAX layout, port index, query,
    docs)}: the
    smoke world's adversarial ids (empty, OOV, past-vocab and -1 terms,
    docs negative and past the end), and a deep hot term whose ranges span
    more than 256 fences at tiles 4 and 8, with docs on every tile edge."""
    from repro.data.synth_corpus import build_zipfian_index
    from repro.dist.sharding import partition_index
    q, docs = adversarial(seine_world, 5)
    out = {("seine", k): (seine_world["index"],) + world_layouts[k] + (q, docs)
           for k in (1, 4)}
    deep = build_zipfian_index(n_docs=DEEP_DOCS)
    edges = np.arange(256, DEEP_DOCS, 512)
    deep_docs = np.unique(np.r_[edges - 1, edges, edges + 1, [4, 8, 12],
                                [-3, -1, 0, DEEP_DOCS - 1, DEEP_DOCS,
                                 DEEP_DOCS + 50]]).astype(np.int32)
    deep_q = np.array([0, 1, 17, 39, -1, 40, 45, 0], np.int32)
    for k in (1, 4):
        ref = jax_layout(deep, k)
        assert k == 1 or ref.split_term is not None
        out[("deep", k)] = (deep, ref, export(ref, tmp_path_factory.mktemp(
            f"deep{k}")), deep_q, deep_docs)
    return out


@pytest.mark.parametrize("tile", (4, 8, 64, 256))
@pytest.mark.parametrize("k", (1, 4))
@pytest.mark.parametrize("world", ("seine", "deep"))
def test_plain_search_bitwise_against_jax(deep_layouts, world, k, tile):
    """``csr_lookup_plain`` -- the kernel's k-ary fence rounds and window
    compare, through the kernel's dataflow -- equals the JAX single-CSR
    oracle (``impl="jnp"``) and the JAX CPU lowering of the same layout
    (sign of zero included) bit for bit: per term (K = 1, the smoke world
    at K = 4) and per pair (the deep world's hot term, split by doc range
    at K = 4); on the deep world at tiles 4 and 8 some range spans more
    than one round of fences."""
    oracle_idx, jax_idx, port, q, docs = deep_layouts[(world, k)]
    want = np.asarray(oracle_idx.qd_matrix(jnp.asarray(q), jnp.asarray(docs),
                                           impl="jnp"))
    jax_ref = np.asarray(jax_idx.qd_matrix(jnp.asarray(q), jnp.asarray(docs)))
    got = port.qd_matrix(t(q), t(docs), impl="kernel", tile=tile).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_ref)
    assert np.array_equal(np.signbit(got), np.signbit(jax_ref))
    assert (want != 0).any() and (want == 0).any()
    if world == "deep" and tile <= 8:
        to, _, _, t2s, rlo = _stacked(port)
        if k == 1:
            _, lo, hi = route_terms(t(q), to, t2s, rlo)
        else:
            shape = (q.size, docs.size)
            _, lo, hi = route_pairs(t(q)[:, None].expand(shape),
                                    t(docs)[None].expand(shape), to, t2s,
                                    rlo, port.split_term, port.split_doc)
        spans = (hi - 1) // tile - lo // tile
        assert int((hi - lo).max()) > WHOLE_RANGE
        assert int(spans.max()) > 32 * FENCE_SEARCH[0]


def test_search_widths_are_the_kernel_sources():
    """The plain version's search widths are the constants csr_lookup.cu
    defines, and the raw kernel instantiates its two warp searches and
    its whole-range cut by those names only, so the plain version cannot
    search in other rounds than the kernel."""
    src = SOURCES["csr_lookup"].read_text()
    body = src[src.index("csr_lookup_kernel("):
               src.index("__global__", src.index("csr_lookup_kernel("))]
    assert re.findall(r"warp_search<([^>]*)>", body) == [
        "kFenceProbes, kFenceMinStep, false", "kIdProbes, kIdMinStep, true"]
    assert "hi0 - lo0 > kWholeRange" in body
    assert min(FENCE_SEARCH + ID_SEARCH) >= 1 and WHOLE_RANGE >= 0


def test_unported_options_raise(hot_layouts):
    _, port = hot_layouts[4]
    args = _stacked(port) + (t([1]), t([0]))
    with pytest.raises(ValueError, match="needs the packed"):
        csr_lookup(*args, codec="packed")
    with pytest.raises(ValueError, match="unknown impl"):
        csr_lookup(*args, impl="interpret")
