"""The packed pair lookup's plain version (``csr_lookup_packed_plain``:
the rounds of ``csr_lookup_packed_kernel`` over all cells at once) held
bitwise (sign of zero included) against the JAX package on the CPU, for
codecs ``packed`` and ``packed-q8`` at codec tiles 8, 64 and 256.

Oracles, all through JAX's jnp lowerings (never the Pallas interpreter):
JAX ``csr_lookup_packed_ref`` over the JAX packed partition; for
``packed`` also the JAX single-CSR ``qd_matrix(impl="jnp")`` and the
port's raw ``csr_lookup_plain`` on the unpacked index; ``packed-q8`` is
held to JAX's q8 M.  Worlds: a deep hot term (one term in every doc, so
at tile 8 its fence range takes several rounds of the fence search;
split by doc range at K = 4, routed per pair), with docs on every tile
edge; and the adversarial K = 2 rows of ``tests/torch_codec_rows.py``
(c = 0 and c = 32 tiles, words with the top bit set, int32 extremes).
The pair grid the coalesced front end launches, (1, P) routed per pair,
is held to the same M.  The CUDA kernel itself is held against this plain
version in tests/test_torch_gpu.py.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.csr_lookup.ref import csr_lookup_packed_ref as jax_ref
from repro_torch.dist.partition import pack_index, unpack_index
from repro_torch.kernels.csr_lookup import csr_lookup_packed_plain
from repro_torch.kernels.csr_lookup.kernel import FENCE_SEARCH
from repro_torch.kernels.csr_lookup.ref import _lane_scale, _route
from repro_torch.kernels.utils import SOURCES
from torch_codec_rows import adversarial_index, adversarial_queries
from torch_helpers import export, t
import torch_threads  # noqa: F401  (PyTorch threads per test process)

CODECS = ("packed", "packed-q8")
TILES = (8, 64, 256)
# one hot term in all 20,402 docs and 39 tail terms: at tile 8 the hot
# term spans 2,551 fences, more than one round of the fence search
DEEP_DOCS = 20402
DEEP_Q = np.array([0, 1, 17, 39, -1, 40, 45, 0], np.int32)


def _jnp(a):
    return None if a is None else jnp.asarray(np.asarray(a))


@pytest.fixture(scope="module")
def deep_index():
    from repro.data.synth_corpus import build_zipfian_index
    return build_zipfian_index(n_docs=DEEP_DOCS)


def _edge_docs(tile):
    """Docs on every tile edge of the hot term's postings (its posting
    at position p is doc p at K = 1), one each side, and past both ends."""
    edges = np.arange(0, DEEP_DOCS + tile, tile)
    return np.unique(np.r_[edges - 1, edges, edges + 1,
                           [-3, DEEP_DOCS + 50]]).astype(np.int32)


def _pairs(p, q, docs):
    """M of the (1, P) pair grid the coalesced lookup launches: every
    (term, doc) pair of the cartesian routed (and scaled) on its own,
    through the plain version; -> (B, Q, n_b, n_f)."""
    shape = (q.shape[0], docs.shape[0])
    terms = q[:, None].expand(shape).reshape(1, -1)
    pair_docs = docs[None].expand(shape).reshape(-1).contiguous()
    k, lo, hi = _route(terms, pair_docs[None], p.term_offsets,
                       p.term_to_shard, p.range_lo, p.split_term,
                       p.split_doc)
    scale = (None if p.value_scale is None else
             _lane_scale(p.value_scale, p.range_lo, k, terms).contiguous())
    i32 = lambda a: a.to(torch.int32).contiguous()  # noqa: E731
    rows = csr_lookup_packed_plain(
        i32(k), i32(lo), i32(hi), pair_docs, p._packed(), p.fences,
        p._serve_values, scale, tile=p.codec_tile)[:, 0]
    return rows.view(shape + rows.shape[1:]).transpose(0, 1)


def _assert_bitwise(got, want, what):
    np.testing.assert_array_equal(got, want, err_msg=what)
    assert np.array_equal(np.signbit(got), np.signbit(want)), what


def _jax_packed_m(p, q, docs):
    """JAX ``csr_lookup_packed_ref`` over a packed partition's arrays."""
    return np.asarray(jax_ref(
        _jnp(p.term_offsets), tuple(_jnp(a) for a in p._packed()),
        _jnp(p.fences), _jnp(p._serve_values), _jnp(p.value_scale),
        _jnp(p.term_to_shard), _jnp(p.range_lo), _jnp(q), _jnp(docs),
        _jnp(p.split_term), _jnp(p.split_doc), tile=p.codec_tile))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("k", (1, 4))
def test_deep_world_bitwise_against_jax(deep_index, tmp_path, k, tile,
                                        codec):
    """Per term (K = 1) and per pair (K = 4, the hot term split by doc
    range): the plain version == JAX's packed ref on the JAX partition;
    ``packed`` also == the JAX single-CSR oracle and the port's raw
    lookup on the unpacked index; the (1, P) pair grid likewise."""
    from repro.dist.sharding import partition_index as jax_partition
    ref = jax_partition(deep_index, k, codec=codec, codec_tile=tile)
    assert k == 1 or ref.split_term is not None
    port = export(ref, tmp_path)
    docs = _edge_docs(tile)
    got = port.qd_matrix(t(DEEP_Q), t(docs), impl="kernel").numpy()
    want = _jax_packed_m(ref, DEEP_Q, docs)
    _assert_bitwise(got, want, "vs JAX csr_lookup_packed_ref")
    _assert_bitwise(_pairs(port, t(DEEP_Q), t(docs)).numpy(), want,
                    "(1, P) pair grid")
    assert (want != 0).any() and (want == 0).any()
    if tile == 8:               # some range takes several fence rounds
        spans = (port.term_offsets[:, 1:] - 1) // tile - (
            port.term_offsets[:, :-1] // tile)
        assert int(spans.max()) > 32 * FENCE_SEARCH[0]
    if codec == "packed":
        oracle = np.asarray(deep_index.qd_matrix(
            jnp.asarray(DEEP_Q), jnp.asarray(docs), impl="jnp"))
        _assert_bitwise(got, oracle, "vs the JAX single-CSR oracle")
        raw = unpack_index(port).qd_matrix(t(DEEP_Q), t(docs),
                                           impl="kernel", tile=tile)
        _assert_bitwise(got, raw.numpy(), "vs the port's raw lookup")


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("tile", TILES)
def test_adversarial_rows_bitwise_against_jax(tile, codec):
    """Huge, negative and int32-extreme ids, c = 0 and c = 32 tiles, words
    with the top bit set: the plain version == JAX's packed ref, per cell
    and as the (1, P) pair grid; ``packed`` == the port's raw lookup."""
    raw = adversarial_index()
    q, docs = adversarial_queries(raw)
    p = pack_index(raw, codec, tile=tile)
    assert (p.tile_bits == 32).any() and (p.packed_words < 0).any()
    got = p.qd_matrix(q, docs, impl="kernel").numpy()
    want = _jax_packed_m(p, q.numpy(), docs.numpy())
    _assert_bitwise(got, want, "vs JAX csr_lookup_packed_ref")
    _assert_bitwise(_pairs(p, q, docs).numpy(), want, "(1, P) pair grid")
    if codec == "packed":
        _assert_bitwise(got, raw.qd_matrix(q, docs, impl="kernel",
                                           tile=tile).numpy(),
                        "vs the port's raw lookup")


def _chosen_classes(p, q, docs):
    """The width classes of the tiles the fence rounds pick for every cell,
    by a plain scan of the term's fences: the first fence >= d among
    (j_lo, j_hi] names tile jf - 1, none names j_hi, clamped into the row."""
    bits = p.tile_bits.numpy()
    fences, tile = p.fences.numpy(), p.codec_tile
    k_n, n_fence = fences.shape
    k, lo, hi = _route(q[None], docs[:, None], p.term_offsets,
                       p.term_to_shard, p.range_lo, p.split_term,
                       p.split_doc)
    out = set()
    for kk, a, b, d in zip(k.reshape(-1).tolist(), lo.reshape(-1).tolist(),
                           hi.reshape(-1).tolist(),
                           docs[:, None].expand(k.shape).reshape(-1)
                           .tolist()):
        kk = min(max(kk, 0), k_n - 1)
        j_lo = a // tile
        j_hi = max((b - 1) // tile, j_lo)
        ge = np.flatnonzero(fences[kk, j_lo + 1:j_hi + 1] >= d)
        jt = min(max((j_lo + ge[0] if ge.size else j_hi), 0), n_fence - 1)
        out.add(int(bits[kk, jt]))
    return out


def test_every_width_class_is_reached(deep_index, tmp_path):
    """The layouts above make the fence rounds pick tiles of every width
    class, c = 0 and c = 32 included, so the decoded probes above read
    every kind of tile."""
    from repro.dist.sharding import partition_index as jax_partition
    raw = adversarial_index()
    q, docs = adversarial_queries(raw)
    seen = set()
    for tile in TILES:
        seen |= _chosen_classes(pack_index(raw, "packed", tile=tile), q,
                                docs)
        ref = jax_partition(deep_index, 4, codec="packed", codec_tile=tile)
        seen |= _chosen_classes(export(ref, tmp_path / str(tile)),
                                t(DEEP_Q), t(_edge_docs(tile)))
    assert seen == {0, 4, 8, 16, 32}


def test_packed_search_widths_are_the_kernel_sources():
    """csr_lookup_packed_kernel instantiates its fence search and its
    search over decoded probes by the raw lookup's named widths only, the
    constants kernel.py reads for the plain versions, so the packed plain
    version cannot search in other rounds than the kernel."""
    src = SOURCES["csr_lookup"].read_text()
    start = src.index("csr_lookup_packed_kernel(")
    body = src[start:src.index("__global__", start)]
    assert re.findall(r"warp_search<([^>]*)>", body) == [
        "kFenceProbes, kFenceMinStep, true", "kIdProbes, kIdMinStep, true"]
    assert "packed_bisect" not in body
