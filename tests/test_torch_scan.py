"""The first-stage scan's work partition in the PyTorch port, held
bitwise (rtol=0/atol=0) against the JAX package on the CPU.

The CUDA scan builds a lane-bounds table once per scan (the first
posting of every lane (query slot, shard) at every doc) and then builds
each doc block's M from it alone, 4 docs per CTA.  Its plain versions
mirror that partition: ``ref.lane_bounds_ref`` /
``ref.lane_bounds_packed_ref`` (the table) and ``ref.assemble_block_ref``
(M from the table), which the wrappers run on CPU tensors.  Here:

* the table equals the JAX bisects a per-block scan runs
  (``repro.core.index._bisect``, ``repro.kernels.csr_lookup.ref.
  packed_bisect``) at every doc, and at a block's two ends its two range
  bisects;
* M assembled from it equals JAX ``retrieve_block_ref`` /
  ``retrieve_block_packed_ref`` under codecs none, packed and packed-q8,
  on the hot-term corpus at K = 1 and K = 4 (split hot terms), blocks of
  1 to 1,024 docs at several ``blo`` (partial last blocks included, and
  blocks that are no multiple of a CTA's 4 docs), empty lanes and a -1
  slot, lanes across codec tile edges (tile 8), and the adversarial ids;
* a table built for a whole scan gives each block the M of a table built
  for that block alone;
* ``csr_retrieve_topk`` through the table gives the JAX engine's top-k
  ids and scores.

The JAX side runs its default CPU dispatch (the jnp ref lowerings), never
the Pallas interpreter.  The CUDA kernels are held against these plain
versions in tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import _bisect as jax_bisect
from repro.dist.sharding import partition_index as jax_partition
from repro.kernels.csr_lookup.ref import packed_bisect as jax_packed_bisect
from repro.kernels.csr_lookup.ref import \
    retrieve_block_packed_ref as jax_block_packed
from repro.kernels.csr_lookup.ref import retrieve_block_ref as jax_block
from repro.retrievers import get_retriever as jax_get
from repro.serving.engine import SeineEngine as JaxEngine
from repro_torch.convert import index_to_device, params_from_jax
from repro_torch.dist.partition import pack_index
from repro_torch.kernels.csr_lookup import (lane_bounds_kernel,
                                            lane_bounds_packed_kernel,
                                            lane_scales, retrieve_lanes,
                                            retrieve_windows_kernel,
                                            retrieve_windows_packed_kernel)
from repro_torch.serving import SeineEngine, make_qmeta
from torch_codec_rows import adversarial_index, adversarial_queries
import torch_threads  # noqa: F401  (PyTorch threads per test process)

CODECS = ("none", "packed", "packed-q8")
# a -1 slot and a past-vocab term: lanes that own nothing
QUERY = (3, 0, -1, 7, 99, 5)
# (block, blo): blocks of 1-3 docs, blocks that are no multiple of 4 docs,
# partial last blocks of the 64-doc corpus (63 + 7, 48 + 64) and blocks
# wider than it
BLOCKS = ((1, 0), (1, 63), (3, 5), (5, 60), (7, 3), (7, 63), (16, 48),
          (64, 0), (64, 48), (100, 0), (1024, 0))


def _jnp(a):
    return None if a is None else jnp.asarray(a.numpy())


@pytest.fixture(scope="module")
def layouts(hot_term_index):
    """{(codec, K): (JAX index, the port's index)}; packed at codec tile
    8, so a lane's postings in a block often cross tile edges."""
    out = {}
    for k in (1, 4):
        ref = jax_partition(hot_term_index, k)
        port = index_to_device(ref, device="cpu")
        if k == 4:
            assert port.split_term is not None
        out["none", k] = (ref, port)
        for codec in CODECS[1:]:
            out[codec, k] = (jax_partition(hot_term_index, k, codec=codec,
                                           codec_tile=8),
                             pack_index(port, codec, tile=8))
    return out


def _lanes(port, q):
    """(lane_lo, lane_hi, lane_scale) of query ``q`` as the ops make them."""
    lo, hi = retrieve_lanes(q, port.term_offsets, port.term_to_shard,
                            port.range_lo, port.range_hi, port.nmax)
    scale = (None if port.value_scale is None
             else lane_scales(port.value_scale, port.range_lo, q))
    return lo.to(torch.int32), hi.to(torch.int32), scale


def _table(codec, port, lo, hi, origin, block, n_blocks):
    if codec == "none":
        return lane_bounds_kernel(port.doc_ids, lo, hi, origin, block,
                                  n_blocks)
    return lane_bounds_packed_kernel(port._packed(), port.fences,
                                     port._serve_values, lo, hi, origin,
                                     block, n_blocks, tile=port.codec_tile)


def _scan(codec, port, lo, hi, scale, blo, block, bounds=None):
    if codec == "none":
        return retrieve_windows_kernel(port.doc_ids, port.values, lo, hi,
                                       blo, block, bounds=bounds)
    return retrieve_windows_packed_kernel(
        port._packed(), port.fences, port._serve_values, scale, lo, hi, blo,
        block, tile=port.codec_tile, bounds=bounds)


# the JAX oracles, jitted: one compile per shape, then each call is cheap
_jax_bisect = jax.jit(jax_bisect, static_argnames=("n_iter",))
_jax_packed_bisect = jax.jit(jax_packed_bisect, static_argnames=("tile",))
_jax_block_raw = jax.jit(jax_block, static_argnames=("block",))
_jax_block_packed = jax.jit(jax_block_packed,
                            static_argnames=("block", "tile"))


def _jax_block(codec, ref, q, blo, block):
    if codec == "none":
        return np.asarray(_jax_block_raw(
            ref.term_offsets, ref.doc_ids, ref.values, ref.term_to_shard,
            ref.range_lo, ref.range_hi, jnp.asarray(q), blo, block=block))
    return np.asarray(_jax_block_packed(
        ref.term_offsets, ref._packed(), ref.fences, ref._serve_values,
        ref.value_scale, ref.term_to_shard, ref.range_lo, ref.range_hi,
        jnp.asarray(q), blo, block=block, tile=ref.codec_tile))


def _jax_positions(codec, port, lo, hi, first, last):
    """The JAX bisect of every lane at every target doc in ``[first,
    last]``: a (Q, K, last - first + 1) table of flat positions."""
    targets = np.arange(first, last + 1, dtype=np.int64).astype(np.int32)
    shape = tuple(lo.shape) + targets.shape
    e = jnp.broadcast_to(jnp.asarray(targets), shape)
    if codec == "none":
        flat = _jnp(port.doc_ids.reshape(-1))
        n_iter = max(int(port.nmax).bit_length(), 1)
        return np.asarray(_jax_bisect(
            flat, jnp.broadcast_to(_jnp(lo)[..., None], shape),
            jnp.broadcast_to(_jnp(hi)[..., None], shape), e, n_iter=n_iter))
    k_n = port.n_shards
    base = np.arange(k_n, dtype=np.int32) * port.nmax
    ks = jnp.broadcast_to(jnp.arange(k_n, dtype=jnp.int32)[:, None], shape)
    pos = _jax_packed_bisect(
        tuple(_jnp(a) for a in port._packed()), _jnp(port.fences), ks,
        jnp.broadcast_to((_jnp(lo) - base)[..., None], shape),
        jnp.broadcast_to((_jnp(hi) - base)[..., None], shape), e,
        tile=port.codec_tile)
    return np.asarray(pos) + base[:, None]


@pytest.fixture(scope="module")
def oracle():
    """Memoised JAX oracles (each JAX call compiles its loops, so every
    distinct one runs once per module): ``oracle(key, fn, *args)``."""
    memo = {}

    def get(key, fn, *args):
        if key not in memo:
            memo[key] = fn(*args)
        return memo[key]
    return get


@pytest.mark.parametrize("origin,block", [(0, 16), (3, 7), (0, 1)])
@pytest.mark.parametrize("k", (1, 4))
@pytest.mark.parametrize("codec", CODECS)
def test_lane_bounds_equal_the_jax_bisects(layouts, oracle, codec, k, origin,
                                           block):
    """Every column of a whole scan's table (the 64-doc corpus in blocks
    from ``origin``) is the position the JAX bisect finds for that doc,
    and a block's first and last columns are the two range bisects of the
    per-block scan; empty lanes stay at their start."""
    _, port = layouts[codec, k]
    q = torch.tensor(QUERY, dtype=torch.int32)
    lo, hi, _ = _lanes(port, q)
    first, last = 0, port.n_docs + 16
    want = oracle(("positions", codec, k), _jax_positions, codec, port, lo,
                  hi, first, last)
    n_blocks = -(-(port.n_docs - origin) // block)
    bounds = _table(codec, port, lo, hi, origin, block, n_blocks)
    got = bounds.table.numpy()
    n_edges = n_blocks * block + 1
    assert got.shape == (len(QUERY), k, n_edges)
    np.testing.assert_array_equal(
        got, want[..., origin - first:origin - first + n_edges])
    empty = (lo == hi).numpy()
    assert empty.any()
    np.testing.assert_array_equal(
        got[empty], np.broadcast_to(lo.numpy()[empty][:, None],
                                    got[empty].shape))
    for b in range(n_blocks):
        e0 = bounds.edge0(origin + b * block, block)
        assert e0 == b * block
        np.testing.assert_array_equal(
            got[..., [e0, e0 + block]],
            want[..., [origin + b * block - first,
                       origin + (b + 1) * block - first]])


@pytest.mark.parametrize("block,blo", BLOCKS)
@pytest.mark.parametrize("k", (1, 4))
@pytest.mark.parametrize("codec", CODECS)
def test_block_assembly_matches_jax(layouts, oracle, codec, k, block, blo):
    """M assembled from the table equals the JAX scan bit for bit (sign of
    zero included), through a table built for the block and through the
    wrappers' own."""
    ref, port = layouts[codec, k]
    q = np.asarray(QUERY, np.int32)
    lo, hi, scale = _lanes(port, torch.from_numpy(q))
    # the JAX scan of docs [0, 1024) holds every block here: a cell's value
    # (0.0 + v, or +0.0) does not depend on the block around it
    want = oracle(("block", codec, k, 0, 1024), _jax_block, codec, ref, q,
                  0, 1024)[blo:blo + block]
    bounds = _table(codec, port, lo, hi, blo, block, 1)
    got = _scan(codec, port, lo, hi, scale, blo, block, bounds).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_array_equal(
        _scan(codec, port, lo, hi, scale, blo, block).numpy(), want)


@pytest.mark.parametrize("block", (7, 16))
@pytest.mark.parametrize("codec", CODECS)
def test_scan_table_serves_every_block(layouts, oracle, codec, block):
    """One table for a whole scan (K = 4) gives every block the M of the
    JAX scan; a block the table was not built for is refused."""
    ref, port = layouts[codec, 4]
    q = np.asarray(QUERY, np.int32)
    lo, hi, scale = _lanes(port, torch.from_numpy(q))
    n_blocks = -(-port.n_docs // block)
    bounds = _table(codec, port, lo, hi, 0, block, n_blocks)
    for b in range(n_blocks):
        got = _scan(codec, port, lo, hi, scale, b * block, block, bounds)
        np.testing.assert_array_equal(got.numpy(), oracle(
            ("block", codec, 4, b * block, block), _jax_block, codec, ref, q,
            b * block, block))
    for blo, blk in ((1, block), (n_blocks * block, block), (0, block + 1)):
        with pytest.raises(ValueError, match="not one of the table"):
            _scan(codec, port, lo, hi, scale, blo, blk, bounds)


def _jax_adversarial_block(codec, port, q, blo, block, tile):
    if codec == "none":
        return np.asarray(_jax_block_raw(
            _jnp(port.term_offsets), _jnp(port.doc_ids), _jnp(port.values),
            _jnp(port.term_to_shard), _jnp(port.range_lo),
            _jnp(port.range_hi), _jnp(q), blo, block=block))
    return np.asarray(_jax_block_packed(
        _jnp(port.term_offsets), tuple(_jnp(a) for a in port._packed()),
        _jnp(port.fences), _jnp(port._serve_values), _jnp(port.value_scale),
        _jnp(port.term_to_shard), _jnp(port.range_lo), _jnp(port.range_hi),
        _jnp(q), blo, block=block, tile=tile))


@pytest.mark.parametrize("codec,tile", [("none", 0), ("packed", 8),
                                        ("packed", 64), ("packed-q8", 8),
                                        ("packed-q8", 64)])
def test_adversarial_ids_match_jax(oracle, codec, tile):
    """Huge, negative and int32-extreme doc ids, 32-bit tiles of words
    with the top bit set, blocks at both ends of the int32 range: the
    table equals the JAX bisects and M the JAX scan."""
    raw = adversarial_index()
    port = raw if codec == "none" else pack_index(raw, codec, tile=tile)
    q, _ = adversarial_queries(raw)
    lo, hi, scale = _lanes(port, q)
    for block, blo in ((256, -(1 << 31)), (64, -8), (256, 1000),
                       (256, (1 << 31) - 300), (7, 40_003)):
        bounds = _table(codec, port, lo, hi, blo, block, 1)
        np.testing.assert_array_equal(bounds.table.numpy(), oracle(
            ("adv positions", codec, tile, blo), _jax_positions, codec, port,
            lo, hi, blo, blo + block))
        got = _scan(codec, port, lo, hi, scale, blo, block, bounds).numpy()
        np.testing.assert_array_equal(got, oracle(
            ("adv block", codec, tile, blo), _jax_adversarial_block, codec,
            port, q, blo, block, tile), err_msg=f"blo={blo}")


def _retrieve_through_table(eng, q, k, doc_block):
    """``SeineEngine.retrieve``'s scan forced onto the kernels' dataflow
    (``impl="kernel"``: the table, then the plain block assembly)."""
    index, n_docs = eng.index, eng.index.n_docs
    q = torch.as_tensor(q, dtype=torch.int32)

    def score_block(m, docs):
        meta = make_qmeta(index, q, docs.clamp(0, n_docs - 1))
        return eng.spec.score(eng.params, m, meta, index.functions)

    with torch.inference_mode():
        return index.retrieve_topk(q, min(k, n_docs), score_block,
                                   doc_block=doc_block, impl="kernel")


@pytest.mark.parametrize("doc_block", (None, 16, 7))
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("k", (1, 4))
def test_topk_through_the_table_matches_jax(hot_term_index, k, codec,
                                            doc_block):
    """The first-stage top-10 (KNRM) through the table: the JAX engine's
    ids, its scores at rtol 1e-5 / atol 1e-6 (the scorer's bar in
    tests/test_torch_engine.py)."""
    jp = jax_get("knrm").init(jax.random.PRNGKey(0), hot_term_index.n_b,
                              hot_term_index.functions)
    kw = ({} if k == 1 and codec == "none" else
          dict(partition="term", n_shards=k, codec=codec))
    jax_eng = JaxEngine(hot_term_index, "knrm", jp, **kw)
    eng = SeineEngine(index_to_device(hot_term_index, device="cpu"), "knrm",
                      params_from_jax("knrm", jp, device="cpu"), **kw)
    for q in (QUERY, (3, 7, -1, 12, -1, -1), (-1,) * 6):
        q = np.asarray(q, np.int32)
        js, ji = jax_eng.retrieve(jnp.asarray(q), 10, doc_block=doc_block)
        s, d = _retrieve_through_table(eng, q, 10, doc_block)
        np.testing.assert_array_equal(d.numpy(), np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-6)
