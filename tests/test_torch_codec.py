"""PyTorch port of the tile-compressed posting codec, held against the
JAX package on the CPU.

* ``core.codec``: the numpy packers are bitwise the reference's, the
  torch decoders (``unpack_at``/``unpack_flat``) agree with JAX's at every
  position, huge and negative ids and 32-bit tiles of top-bit words
  included, and the torch quantiser equals the numpy one.
* The served index: ``packed`` M equals JAX ``csr_lookup_packed_ref`` and
  the port's raw M bit for bit over K x tile, on the ref path and on the
  kernels' plain versions (``impl="kernel"``), also on the hot-term
  sub-sharded corpus; ``packed-q8`` M equals JAX's q8 M bit for bit; the
  scan, top-k ids and engine scores match; packed and q8 ``save_index``
  directories load; the reference's construction guards hold.

The JAX side runs through its default CPU dispatch (the jnp ref
lowerings), never the Pallas interpreter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.dist.partition import pack_index as jax_pack_index
from repro.dist.partition import unpack_index as jax_unpack_index
from repro.dist.sharding import partition_index as jax_partition
from repro.kernels.csr_lookup import csr_retrieve_block as jax_retrieve
from repro.kernels.csr_lookup.ref import csr_lookup_packed_ref as jax_ref
from repro.retrievers import get_retriever as jax_get
from repro.serving.engine import SeineEngine as JaxEngine
from repro_torch.convert import index_to_device, params_from_jax
from repro_torch.core import codec
from repro_torch.dist.partition import pack_index, unpack_index
from repro_torch.dist.sharding import partition_index
from repro_torch.kernels.csr_lookup import (csr_lookup, csr_retrieve_block,
                                            lookup_pairs_packed_ref)
from repro_torch.serving import SeineEngine
from torch_codec_rows import (INT32_MAX, INT32_MIN, adversarial_index,
                              adversarial_queries, adversarial_rows)
from torch_helpers import (K_SWEEP, TILE_SWEEP, adversarial,
                           assert_same_partition, export, t)
import torch_threads  # noqa: F401  (PyTorch threads per test process)

CODECS = ("packed", "packed-q8")
TOL = dict(rtol=1e-5, atol=1e-6)


def _jnp(a):
    return None if a is None else jnp.asarray(a.numpy())


def _rows(seed):
    """Adversarial stacked rows: the port's fixture rows plus a constant
    row, a huge-id row and one with int32 min (top-bit words at c=32)."""
    rows, _ = adversarial_rows(seed)
    n = rows.shape[1]
    extra = np.stack([np.full(n, 42), np.r_[np.zeros(n - 2), INT32_MAX - 1,
                                            INT32_MAX],
                      np.r_[INT32_MIN, np.zeros(n - 1)]]).astype(np.int32)
    return np.concatenate([rows, np.sort(extra, axis=1)])


# ---------------------------------------------------------------------------
# core.codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("tile", (8,) + TILE_SWEEP)
def test_packers_match_jax(tile, seed):
    rows = _rows(seed)
    got, want = codec.pack_doc_ids(rows, tile), jcodec.pack_doc_ids(rows,
                                                                    tile)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got.nbytes == want.nbytes
    assert (got.tile_bits == 32).any() and (got.packed_words < 0).any()
    for i, row in enumerate(rows):
        for g, w in zip(codec.pack_row(row, tile), jcodec.pack_row(row,
                                                                   tile)):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    np.testing.assert_array_equal(codec.unpack_doc_ids(got), rows)
    np.testing.assert_array_equal(
        codec.unpack_row(got.packed_words[1], got.tile_bits[1],
                         got.tile_base[1], got.tile_word_off[1], tile=tile,
                         n=rows.shape[1]), rows[1])
    args = (got.tile_bits, got.tile_base, got.tile_word_off,
            got.packed_words)
    for n in (rows.shape[1], rows.shape[1] - tile // 2, 0):
        np.testing.assert_array_equal(
            codec.fences_from_packed(*args, tile=tile, n=n),
            jcodec.fences_from_packed(*args, tile=tile, n=n))


def test_pack_guards_and_edge_rows():
    with pytest.raises(ValueError, match="multiple of 8"):
        codec.pack_row(np.arange(10, dtype=np.int32), 100)
    with pytest.raises(ValueError, match="stacked"):
        codec.pack_doc_ids(np.arange(10, dtype=np.int32), 8)
    words, bits, _, _ = codec.pack_row(np.empty(0, np.int32), 64)
    assert words.shape == (0,) and bits.shape == (1,)
    assert codec.validate_codec(None) == "none"
    with pytest.raises(ValueError, match="unknown codec"):
        codec.validate_codec("zstd")


@pytest.mark.parametrize("tile", (8, 64, 256))
def test_unpack_at_matches_jax(tile):
    """Every position of every row, plus clipped ones, decodes as JAX's
    ``unpack_at`` does: 32-bit tiles of top-bit words, huge ids, 4- to
    16-bit tiles whose words have the top bit set."""
    rows = _rows(2)
    p = codec.pack_doc_ids(rows, tile)
    assert (p.tile_bits == 32).any() and (p.packed_words < 0).any()
    k_n, n = rows.shape
    k = np.repeat(np.arange(-1, k_n + 1), n + 12).astype(np.int32)
    pos = np.tile(np.arange(-5, n + 7), k_n + 2).astype(np.int32)
    packed = [torch.from_numpy(a) for a in p[:4]]
    got = codec.unpack_at(*packed, torch.from_numpy(k),
                          torch.from_numpy(pos), tile=tile)
    want = jcodec.unpack_at(*[jnp.asarray(a) for a in p[:4]],
                            jnp.asarray(k), jnp.asarray(pos), tile=tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    live = (k >= 0) & (k < k_n) & (pos >= 0) & (pos < n)
    np.testing.assert_array_equal(got.numpy()[live], rows[k[live], pos[live]])
    flat = np.arange(-3, k_n * n + 3, dtype=np.int32)
    np.testing.assert_array_equal(
        codec.unpack_flat(*packed, torch.from_numpy(flat), tile=tile,
                          nmax=n).numpy(),
        np.asarray(jcodec.unpack_flat(*[jnp.asarray(a) for a in p[:4]],
                                      jnp.asarray(flat), tile=tile,
                                      nmax=n)))


def test_quantizers_match_jax(seine_world):
    """The numpy copy and the torch quantiser equal the reference's numpy
    quantiser bit for bit, halves (round to even) and padding included."""
    p = jax_partition(seine_world["index"], 3)
    values = np.array(p.values)
    offs = np.array(p.term_offsets)
    # one term with scale 1.0 exactly (peak 127) whose entries are halves
    w = int(np.flatnonzero(np.diff(offs[0]) > 0)[0])
    lo, hi = offs[0, w], offs[0, w + 1]
    values[0, lo:hi] = (np.arange(values[0, lo:hi].size).reshape(
        values[0, lo:hi].shape) % 9 - 4.5).astype(np.float32)
    values[0, lo, 0, 0] = 127.0
    want_q, want_s = jcodec.quantize_values(values, offs)
    for got_q, got_s in (codec.quantize_values(values, offs),
                         codec.quantize_values_torch(
                             torch.from_numpy(values),
                             torch.from_numpy(offs))):
        got_q, got_s = np.asarray(got_q), np.asarray(got_s)
        np.testing.assert_array_equal(got_q, want_q)
        np.testing.assert_array_equal(got_s, want_s)
        assert got_q.dtype == np.int8 and got_s.dtype == np.float32


# ---------------------------------------------------------------------------
# the served index
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(seine_world):
    return index_to_device(seine_world["index"], device="cpu")


def _pair(jax_idx, port_raw, k, codec_name, tile):
    """(JAX packed partition, the port's own partition + pack of the raw
    index), checked array for array."""
    ref = jax_partition(jax_idx, k, codec=codec_name, codec_tile=tile)
    got = partition_index(port_raw, k, codec=codec_name, codec_tile=tile)
    assert_same_partition(got, ref)
    return ref, got


@pytest.mark.parametrize("impl", [None, "kernel"])
@pytest.mark.parametrize("tile", TILE_SWEEP)
@pytest.mark.parametrize("k", K_SWEEP)
def test_packed_qd_matrix_bitwise(seine_world, world, k, tile, impl):
    """``packed`` M == JAX ``csr_lookup_packed_ref`` == the port's raw M,
    bit for bit, on both port paths; ``pack_index`` of the port's raw
    partition gives the same index."""
    ref, got = _pair(seine_world["index"], world, k, "packed", tile)
    raw = partition_index(world, k)
    assert_same_partition(pack_index(raw, "packed", tile=tile), ref)
    for seed in range(2):
        q, docs = adversarial(seine_world, seed)
        want = np.asarray(ref.qd_matrix(jnp.asarray(q), jnp.asarray(docs)))
        m = got.qd_matrix(t(q), t(docs), impl=impl).numpy()
        np.testing.assert_array_equal(m, want, err_msg=f"seed={seed}")
        assert np.array_equal(np.signbit(m), np.signbit(want))
        np.testing.assert_array_equal(
            m, world.qd_matrix(t(q), t(docs), tile=tile).numpy())


@pytest.mark.parametrize("impl", [None, "kernel"])
@pytest.mark.parametrize("k", K_SWEEP)
def test_q8_qd_matrix_bitwise(seine_world, world, k, impl):
    """``packed-q8`` M == JAX q8 M bit for bit; ids stay lossless and
    values within half a step of the term's scale."""
    ref, got = _pair(seine_world["index"], world, k, "packed-q8", 256)
    exact = world.qd_matrix
    for seed in range(2):
        q, docs = adversarial(seine_world, seed)
        want = np.asarray(ref.qd_matrix(jnp.asarray(q), jnp.asarray(docs)))
        m = got.qd_matrix(t(q), t(docs), impl=impl).numpy()
        np.testing.assert_array_equal(m, want, err_msg=f"seed={seed}")
        e = exact(t(q), t(docs)).numpy()
        np.testing.assert_array_equal(m != 0, e != 0)
        assert np.abs(m - e).max() <= got.value_scale.max().item() / 2 + 1e-6


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("impl", [None, "kernel"])
@pytest.mark.parametrize("k", (4, 8))
def test_sub_sharded_hot_term_packed(hot_term_index, k, impl, codec_name):
    """Per-pair routing of a hot term split by doc range, over packed
    tiles at several widths: equal to JAX's packed ref bit for bit."""
    port_raw = index_to_device(hot_term_index, device="cpu")
    for tile in (8, 64):
        ref, got = _pair(hot_term_index, port_raw, k, codec_name, tile)
        assert got.split_term is not None
        splits = got.split_doc.numpy()[got.split_term.numpy() >= 0]
        q = np.array([0, 1, 17, -1, hot_term_index.vocab_size + 3, 39],
                     np.int32)
        docs = np.concatenate([splits, splits - 1,
                               [0, hot_term_index.n_docs - 1,
                                hot_term_index.n_docs, -3]]).astype(np.int32)
        want = np.asarray(ref.qd_matrix(jnp.asarray(q), jnp.asarray(docs)))
        np.testing.assert_array_equal(
            got.qd_matrix(t(q), t(docs), impl=impl).numpy(), want)


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("tile", (8, 64, 256))
def test_adversarial_ids_match_jax(tile, codec_name):
    """Huge, negative and int32-extreme doc ids (32-bit tiles of top-bit
    words): JAX's packed ref == the port's ref == the kernels' plain
    version; ``packed`` == the raw lookup."""
    raw = adversarial_index()
    q, docs = adversarial_queries(raw)
    p = pack_index(raw, codec_name, tile=tile)
    want = np.asarray(jax_ref(
        _jnp(p.term_offsets), tuple(_jnp(a) for a in p._packed()),
        _jnp(p.fences), _jnp(p._serve_values), _jnp(p.value_scale),
        _jnp(p.term_to_shard), _jnp(p.range_lo), _jnp(q), _jnp(docs),
        tile=tile))
    for impl in ("ref", "kernel"):
        np.testing.assert_array_equal(
            p.qd_matrix(q, docs, impl=impl).numpy(), want)
    if codec_name == "packed":
        np.testing.assert_array_equal(want, raw.qd_matrix(q, docs).numpy())
    # the generic-batch pair lookup
    terms = q[None].expand(docs.shape[0], -1)
    np.testing.assert_array_equal(p.lookup_pairs(terms, docs).numpy(), want)


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("k", K_SWEEP)
@pytest.mark.parametrize("block,blo", [(64, 0), (16, 48), (7, 3)])
def test_retrieve_block_matches_jax(hot_term_index, k, block, blo,
                                    codec_name):
    """Scanned packed M blocks equal JAX's (sign of zero included) on the
    ref path and on the fused kernel's plain version; ``packed`` blocks
    also equal the raw index's."""
    port_raw = index_to_device(hot_term_index, device="cpu")
    ref, got = _pair(hot_term_index, port_raw, k, codec_name, 8)
    q = np.array([3, 0, -1, 7, 99, 5], np.int32)
    want = np.asarray(jax_retrieve(
        ref.term_offsets, None, ref._serve_values, ref.term_to_shard,
        ref.range_lo, ref.range_hi, jnp.asarray(q), blo, block=block,
        tile=8, codec=codec_name, packed=ref._packed(),
        value_scale=ref.value_scale, max_tile_words=ref.max_tile_words,
        codec_spans=ref.codec_spans, fences=ref.fences))
    raw = partition_index(port_raw, k)
    for impl in (None, "kernel"):
        m = csr_retrieve_block(
            got.term_offsets, None, got._serve_values, got.term_to_shard,
            got.range_lo, got.range_hi, t(q), blo, block=block, tile=8,
            impl=impl, fences=got.fences, **got._codec_kwargs()).numpy()
        np.testing.assert_array_equal(m, want, err_msg=f"impl={impl}")
        assert np.array_equal(np.signbit(m), np.signbit(want))
        if codec_name == "packed":
            np.testing.assert_array_equal(m, csr_retrieve_block(
                raw.term_offsets, raw.doc_ids, raw.values, raw.term_to_shard,
                raw.range_lo, raw.range_hi, t(q), blo, block=block).numpy())


@pytest.mark.parametrize("codec_name", CODECS)
def test_tombstones_match_jax(hot_term_index, codec_name):
    port_raw = index_to_device(hot_term_index, device="cpu")
    ref, got = _pair(hot_term_index, port_raw, 4, codec_name, 64)
    alive = np.random.RandomState(3).rand(hot_term_index.n_docs) > 0.3
    q = np.array([3, 0, -1, 7, 99, 5], np.int32)
    docs = np.array([0, 1, 2, 5, 17, 63, 64, -1], np.int32)
    want = np.asarray(ref.qd_matrix(jnp.asarray(q), jnp.asarray(docs),
                                    alive=jnp.asarray(alive)))
    want_b = np.asarray(jax_retrieve(
        ref.term_offsets, None, ref._serve_values, ref.term_to_shard,
        ref.range_lo, ref.range_hi, jnp.asarray(q), 0, block=64, tile=64,
        codec=codec_name, packed=ref._packed(), value_scale=ref.value_scale,
        max_tile_words=ref.max_tile_words, codec_spans=ref.codec_spans,
        fences=ref.fences, alive=jnp.asarray(alive)))
    for impl in (None, "kernel"):
        np.testing.assert_array_equal(got.qd_matrix(
            t(q), t(docs), impl=impl, alive=torch.from_numpy(alive)).numpy(),
            want)
        np.testing.assert_array_equal(csr_retrieve_block(
            got.term_offsets, None, got._serve_values, got.term_to_shard,
            got.range_lo, got.range_hi, t(q), 0, block=64, tile=64,
            impl=impl, fences=got.fences, alive=torch.from_numpy(alive),
            **got._codec_kwargs()).numpy(), want_b)


def _engines(jax_idx, port_raw, codec_name, n_shards, name="knrm"):
    jp = jax_get(name).init(jax.random.PRNGKey(0), jax_idx.n_b,
                            jax_idx.functions)
    kw = dict(partition="term", n_shards=n_shards, codec=codec_name)
    return (JaxEngine(jax_idx, name, jp, **kw),
            SeineEngine(port_raw, name,
                        params_from_jax(name, jp, device="cpu"), **kw))


@pytest.mark.parametrize("name", ["knrm", "deeptilebars", "hint",
                                  "deepimpact"])
@pytest.mark.parametrize("codec_name", CODECS)
def test_engine_scores_and_topk_match_jax(seine_world, world, codec_name,
                                          name):
    """``SeineEngine(partition="term", n_shards=2, codec=...)``: scores
    at rtol 1e-5 / atol 1e-6 and top-k ids equal to the JAX engine's,
    ties toward the lower doc id; ``packed`` scores equal the raw
    engine's."""
    jax_eng, eng = _engines(seine_world["index"], world, codec_name, 2,
                            name)
    assert eng.index.codec == codec_name and eng.index.n_shards == 2
    raw = SeineEngine(world, name, eng.params)
    all_docs = np.arange(world.n_docs, dtype=np.int32)
    queries = [adversarial(seine_world, 0)[0]] + [
        np.asarray(x, np.int32) for x in seine_world["queries"][:2]]
    for q in queries:
        got = eng.score(q, all_docs).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_eng.score(
            jnp.asarray(q), jnp.asarray(all_docs))), **TOL)
        if codec_name == "packed":
            np.testing.assert_array_equal(got,
                                          raw.score(q, all_docs).numpy())
        s, d = eng.retrieve(q, 10)
        js, jd = jax_eng.retrieve(jnp.asarray(q), 10)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
        for i in range(9):
            if s[i] == s[i + 1]:
                assert d[i] < d[i + 1]


def test_q8_recall_at_10(seine_world, world):
    """The reference's effectiveness bar: q8 top-10 keeps >= 90% of the
    exact engine's over the first queries."""
    _, q8 = _engines(seine_world["index"], world, "packed-q8", 2)
    exact = SeineEngine(world, "knrm", q8.params, partition="term",
                        n_shards=2)
    hits = 0
    for q in seine_world["queries"][:4]:
        hits += len(set(exact.retrieve(q, 10)[1].tolist())
                    & set(q8.retrieve(q, 10)[1].tolist()))
    assert hits / 40 >= 0.9


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("k", (1, 4))
def test_jax_saved_packed_index_loads(hot_term_index, tmp_path, k,
                                      codec_name):
    """JAX ``save_index`` of a packed index -> port ``load_index``: every
    array equal, the fences rebuilt from the packed tile metadata equal
    the reference's, and M equals the JAX index's."""
    ref = jax_partition(hot_term_index, k, codec=codec_name, codec_tile=64)
    port = export(ref, tmp_path / "idx")
    assert_same_partition(port, ref)
    assert_same_partition(index_to_device(ref, device="cpu"), ref)
    q = np.array([0, 1, 17, -1, 45, 39], np.int32)
    docs = np.arange(-2, hot_term_index.n_docs + 2, dtype=np.int32)
    np.testing.assert_array_equal(
        port.qd_matrix(t(q), t(docs)).numpy(),
        np.asarray(ref.qd_matrix(jnp.asarray(q), jnp.asarray(docs))))


@pytest.mark.parametrize("codec_name", CODECS)
def test_pack_and_unpack_index_match_jax(seine_world, world, codec_name):
    ref_raw = jax_partition(seine_world["index"], 2)
    raw = partition_index(world, 2)
    p = pack_index(raw, codec_name, tile=64)
    ref = jax_pack_index(ref_raw, codec_name, tile=64)
    assert_same_partition(p, ref)
    assert pack_index(raw, "none") is raw
    with pytest.raises(ValueError, match="already packed"):
        pack_index(p, "packed")
    assert_same_partition(unpack_index(p), jax_unpack_index(ref))
    assert unpack_index(raw) is raw
    assert p.posting_nbytes == ref.posting_nbytes
    assert p.nbytes == ref.nbytes and p.nmax == ref.nmax


class TestConstructionGuards:
    """tests/test_codec.py::TestConstructionGuards, on the port."""

    def test_packed_rejects_tile_override(self, world):
        p = partition_index(world, 2, codec="packed", codec_tile=64)
        q, docs = t([3, 0, -1]), torch.arange(8, dtype=torch.int32)
        with pytest.raises(ValueError, match="does not match"):
            p.qd_matrix(q, docs, tile=256)
        with pytest.raises(ValueError, match="does not match"):
            p.retrieve_topk(q, 3, lambda m, d: m.sum((1, 2, 3)), tile=256)
        p.qd_matrix(q, docs, tile=64)             # matching tile is fine
        with pytest.raises(ValueError, match="does not match the packed"):
            csr_lookup(p.term_offsets, None, p.values, p.term_to_shard,
                       p.range_lo, q, docs, fences=p.fences, tile=256,
                       **p._codec_kwargs())

    def test_packed_rejects_unknown_impl(self, world):
        p = partition_index(world, 2, codec="packed")
        with pytest.raises(ValueError, match="unknown impl"):
            p.qd_matrix(t([3]), torch.arange(8, dtype=torch.int32),
                        impl="jnp")

    def test_ops_need_the_packed_arrays(self, world):
        p = partition_index(world, 2, codec="packed-q8")
        args = (p.term_offsets, None, p.values_q, p.term_to_shard,
                p.range_lo, t([3]), t([0]))
        with pytest.raises(ValueError, match="needs the packed"):
            csr_lookup(*args, fences=p.fences, codec="packed-q8")
        with pytest.raises(ValueError, match="fence rows"):
            csr_lookup(*args, codec="packed-q8", packed=p._packed())
        with pytest.raises(ValueError, match="int8"):
            csr_lookup(*args[:2], p.values_q.float(), *args[3:],
                       fences=p.fences, codec="packed-q8",
                       packed=p._packed(), value_scale=p.value_scale)
        with pytest.raises(ValueError, match="unknown codec"):
            csr_lookup(*args, codec="zstd")
        pairs = lookup_pairs_packed_ref(
            p.term_offsets, p._packed(), p.fences, p.values_q,
            p.value_scale, p.term_to_shard, p.range_lo, t([[3, 0]]), t([1]),
            tile=p.codec_tile)
        assert pairs.shape == (1, 2) + tuple(p.values_q.shape[2:])

    def test_engine_codec_needs_term_partition(self, world):
        params = _engines_params(world)
        with pytest.raises(ValueError, match="partition='term'"):
            SeineEngine(world, "knrm", params, codec="packed")

    def test_engine_rejects_codec_conflict(self, world):
        p = partition_index(world, 2, codec="packed")
        params = _engines_params(world)
        with pytest.raises(ValueError, match="conflicts"):
            SeineEngine(p, "knrm", params, codec="packed-q8")
        SeineEngine(p, "knrm", params, codec="packed")  # re-stated: fine

    def test_engine_rejects_mesh_with_packed(self, world):
        p = partition_index(world, 1, codec="packed")
        with pytest.raises(NotImplementedError, match="mesh"):
            SeineEngine(p, "knrm", _engines_params(world), mesh=object())

    def test_engine_rejects_lookup_tile_mismatch(self, world):
        p = partition_index(world, 2, codec="packed", codec_tile=64)
        params = _engines_params(world)
        with pytest.raises(ValueError, match="codec tile"):
            SeineEngine(p, "knrm", params, lookup_tile=256)
        with pytest.raises(ValueError, match="codec tile"):
            SeineEngine(world, "knrm", params, partition="term",
                        n_shards=2, codec="packed", codec_tile=64,
                        lookup_tile=256)
        SeineEngine(p, "knrm", params, lookup_tile=64)

    def test_engine_rejects_bad_n_shards(self, world):
        with pytest.raises(ValueError, match="n_shards"):
            SeineEngine(world, "knrm", _engines_params(world),
                        partition="term", n_shards=0)


def _engines_params(index):
    from repro_torch.retrievers import get_retriever
    return get_retriever("knrm").init(torch.Generator().manual_seed(0),
                                      index.n_b, index.functions,
                                      device="cpu")


def test_packed_index_fields(world):
    p = partition_index(world, 2, codec="packed-q8", codec_tile=64)
    assert p.doc_ids is None and p.values is None
    assert p._serve_values is p.values_q
    q8_bytes = p.posting_nbytes
    assert unpack_index(p).posting_nbytes > 3 * q8_bytes
