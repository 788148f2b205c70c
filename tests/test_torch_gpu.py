"""The port's CUDA kernels on the card, each held against its plain
PyTorch version on the same inputs (bitwise for the lookups and the
scans, raw and packed, rtol 1e-5 / atol 1e-6 for the KNRM bank, rtol
1e-4 / atol 1e-5 for seg_interact and float32 flash_attn, whose plain
versions sum in another order, 2e-2 for bf16 flash_attn), the engine on
CUDA, raw and packed, against the engine on the CPU, and the offline
build on the card against the same build on the CPU, with a HashProvider
and with an LMProvider.

embed_bag (its CSR and its segment entry), the provider's segment sums
and the serving front end on the card are held bitwise against the
plain versions and ``engine.score``.  bf16 flash_attn runs on the tensor
cores (``wgmma``, TMA loads), held against the plain version at every
head width.

The flash_attn backward kernel is held against its plain version from
the forward kernel's o and lse (float32 at rtol 1e-4 / atol 1e-5, bf16
with at most 0.1% of values past 2e-2), bitwise run to run; the forward
keeps its bits (digests of the tree before it could write an lse), and
a smoke LM's training steps on the card match the CPU's.

The first-stage scan's lane-bounds table and its block kernels are held
bitwise against their plain versions and the independent per-block
reference over every block of a scan, with one table launch per scan, and
M is shown to be written without a memset.

This file imports neither jax nor repro, so it runs on a GPU host that
has only PyTorch: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``.  Without a CUDA device every test skips.
"""
import copy
import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from repro_torch.ckpt import load_index
from repro_torch.configs import seine_smoke, smoke
from repro_torch.core.builder import IndexBuilder
from repro_torch.core.codec import quantize_values, quantize_values_torch
from repro_torch.core.interactions import init_interaction_params
from repro_torch.core.providers import HashProvider, LMProvider
from repro_torch.core.segment import segment_corpus
from repro_torch.core.vocab import build_vocabulary
from repro_torch.data.synth_corpus import build_zipfian_index, generate
from repro_torch.dist.partition import pack_index
from repro_torch.dist.sharding import partition_index
from repro_torch.kernels.embed_bag import (bag_ptr_from_offsets,
                                           embed_bag_kernel, embed_bag_plain,
                                           embed_bag_segment_kernel,
                                           segment_bag_sums,
                                           segment_bag_sums_plain)
from repro_torch.core.index import build_fences
from repro_torch.kernels.csr_lookup import (csr_lookup_kernel,
                                            csr_lookup_packed_kernel,
                                            csr_lookup_plain,
                                            lane_bounds_kernel,
                                            lane_bounds_packed_kernel,
                                            lane_scales, retrieve_lanes,
                                            retrieve_windows_kernel,
                                            retrieve_windows_packed_kernel,
                                            route_pairs, route_terms,
                                            scan_block_packed_ref,
                                            scan_block_ref)
from repro_torch.kernels.csr_lookup.kernel import csr_lookup_packed_plain
from repro_torch.kernels.csr_lookup.ops import _route_cells
from repro_torch.kernels.csr_lookup.ref import _lane_scale, _route
from repro_torch.kernels.flash_attn import (flash_attention,
                                            flash_attn_bwd_kernel,
                                            flash_attn_bwd_plain,
                                            flash_attn_kernel,
                                            flash_attn_plain)
from repro_torch.kernels.knrm_pool import knrm_pool_kernel, knrm_pool_ref
from repro_torch.kernels.seg_interact import (seg_interact,
                                              seg_interact_kernel,
                                              seg_interact_plain)
from repro_torch.models import transformer as T
from repro_torch.retrievers import get_retriever
from repro_torch.serving import (NoIndexEngine, SeineEngine,
                                 ServingFrontend)
from repro_torch.tree import flatten_with_paths, tree_map
from torch_codec_rows import adversarial_index, adversarial_queries
import torch_threads  # noqa: F401  (PyTorch threads per test process)

pytestmark = pytest.mark.gpu

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_hot_term_k4")
TOL = dict(rtol=1e-5, atol=1e-6)
# The float32 kernels are held against their plain versions run on the
# card: on the H100 host, PyTorch's CPU exp was seen to return values up
# to 1.05e-4 off on its first call in a process (in 1 of 60 processes; the
# same call again was right), which failed flash_attn's float32 test in 3
# of 30 fresh processes while the kernel gave the same bits in every one
# (scripts/flash_attn_f32_repro.py).


def _require_cuda():
    # decided inside the test, never at collection: every xdist worker
    # must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _index(layout, device):
    if layout == "k1":
        return build_zipfian_index(n_docs=300, vocab=50, tail_decay=0.7,
                                   n_b=4, device=device)
    return load_index(FIXTURE, device=device)     # K=4, hot term split


def _stacked(idx):
    if hasattr(idx, "term_to_shard"):
        return (idx.term_offsets, idx.doc_ids, idx.values,
                idx.term_to_shard, idx.range_lo, idx.range_hi)
    return (idx.term_offsets[None], idx.doc_ids[None], idx.values[None],
            None, None, None)


@pytest.mark.parametrize("layout", ["k1", "k4"])
def test_lookup_and_scan_kernels_match_plain(layout):
    _require_cuda()
    cpu, gpu = _index(layout, "cpu"), _index(layout, "cuda")
    q = torch.tensor([0, 1, 17, -1, 45, 39, 3, 1000], dtype=torch.int32)
    docs = torch.arange(-2, gpu.n_docs + 3, dtype=torch.int32)
    before = csr_lookup_kernel.launches
    for tile in (4, 64, 256, 1024):
        want = cpu.qd_matrix(q, docs, impl="kernel", tile=tile)
        got = gpu.qd_matrix(q.cuda(), docs.cuda(), tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), f"tile={tile}"
    assert csr_lookup_kernel.launches == before + 4
    to, dids, vals, t2s, rlo, rhi = _stacked(gpu)
    lo, hi = retrieve_lanes(q.cuda(), to, t2s, rlo, rhi, dids.shape[1])
    for block, blo in ((64, 0), (16, 48), (7, 3), (1024, 0)):
        got = retrieve_windows_kernel(dids, vals, lo, hi, blo, block,
                                      tile=4)
        want = retrieve_windows_kernel(dids.cpu(), vals.cpu(), lo.cpu(),
                                       hi.cpu(), blo, block, tile=4)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (block, blo)


@pytest.mark.parametrize("shape", [(1, 1, 1), (1000, 6, 20), (5, 130, 7)])
def test_knrm_pool_kernel_matches_plain(shape):
    _require_cuda()
    g = torch.Generator().manual_seed(0)
    cos = torch.rand(shape, generator=g) * 2 - 1
    cos.view(-1)[::7] = 1.0
    mask = (torch.rand((shape[0], shape[2]), generator=g) > 0.25).float()
    mask[0] = 0.0
    got = knrm_pool_kernel(cos.cuda(), mask.cuda())
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), knrm_pool_ref(cos, mask), **TOL)


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary, so a kernel takes its scalar path."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


# one hot term in all 9,138 docs (n_b 4: 36-float rows): at tile 4 its
# range spans 2,285 fences, two rounds of the kernel's fence search
DEEP_DOCS = 9138


def _lookup_case(layout):
    """(index on the card, query, docs) of the lookup kernel's tests."""
    q = torch.tensor([0, 1, 17, -1, 45, 39, 3, 1000], dtype=torch.int32,
                     device="cuda")
    if layout == "deep":
        idx = build_zipfian_index(n_docs=DEEP_DOCS, n_b=4, device="cuda")
        edges = torch.arange(64, DEEP_DOCS, 64, dtype=torch.int32)
        docs = torch.cat([edges - 1, edges, edges + 1, torch.tensor(
            [-3, 0, DEEP_DOCS - 1, DEEP_DOCS, DEEP_DOCS + 50],
            dtype=torch.int32)]).cuda()
        return idx, q, docs
    idx = _index(layout, "cuda")
    return idx, q, torch.arange(-2, idx.n_docs + 3, dtype=torch.int32,
                                device="cuda")


@pytest.mark.parametrize("layout", ["k1", "k4", "deep"])
def test_lookup_kernel_matches_plain_per_term_and_per_pair_grid(layout):
    """The raw lookup kernel against its plain version, both on the card,
    bit for bit (sign of zero included): routed as the layout routes
    (per term at K = 1, per pair on the sub-sharded K = 4 fixture) and as
    the coalesced front end's (1, P) grid of pairs each routed on its own,
    at tiles 4, 64, 256 and 1024.  The fixture's 18-float rows and a
    misaligned copy of the values take the scalar row copy; the deep
    index needs several rounds of fence search at tile 4."""
    _require_cuda()
    idx, q, docs = _lookup_case(layout)
    to, dids, vals, t2s, rlo, _ = _stacked(idx)
    split = getattr(idx, "split_term", None)
    shape = (q.shape[0], docs.shape[0])
    pair_t = q[:, None].expand(shape).reshape(1, -1)
    pair_d = docs[None].expand(shape).reshape(1, -1)
    if split is None:
        grid = route_terms(q, to, t2s, rlo)
        pairs = route_terms(pair_t, to, t2s, rlo)
    else:
        grid = route_pairs(q[:, None].expand(shape), docs[None].expand(shape),
                           to, t2s, rlo, split, idx.split_doc)
        pairs = route_pairs(pair_t, pair_d, to, t2s, rlo, split,
                            idx.split_doc)
    i32 = lambda xs: [x.to(torch.int32).contiguous() for x in xs]  # noqa
    before = csr_lookup_kernel.launches
    for tile in (4, 64, 256, 1024):
        fences = build_fences(dids, tile)
        for route, d in ((grid, docs), (pairs, pair_d[0].contiguous())):
            args = (*i32(route), d, dids, fences)
            got = csr_lookup_kernel(*args, vals, tile=tile)
            want = csr_lookup_plain(*args, vals, tile=tile)
            assert torch.equal(got, want), (tile, route[0].shape)
            assert torch.equal(got.signbit(), want.signbit())
            if tile == 256:
                mis = csr_lookup_kernel(*args, _misaligned(vals), tile=tile)
                assert torch.equal(mis, want) and torch.equal(
                    mis.signbit(), want.signbit())
    assert csr_lookup_kernel.launches == before + 10
    assert (want != 0).any()


@pytest.mark.parametrize("shape,c_lo", [
    ((1000, 6, 20), -1.0), ((1000, 6, 20), 0.99), ((37, 1, 20), -1.0),
    ((9, 1, 7), 0.99), ((4, 6, 3), -1.0), ((11, 6, 3), 0.99)])
def test_knrm_pool_kernel_matches_plain_on_the_card(shape, c_lo):
    """The RBF bank against its plain version run on the card at rtol
    1e-5 / atol 1e-6: n_b not a multiple of 4, Q = 1 (the coalesced front
    end), B * Q not a multiple of the kernel's 16-row tile, a fully masked
    candidate, and cos_norm in [0.99, 1.0], where the exact-match kernel
    (sigma 1e-3) spans exp(0) to exp(-50).  A misaligned copy of the
    inputs takes the scalar staging and gives the same bits."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    cos = torch.rand(shape, generator=g, device="cuda") * (1 - c_lo) + c_lo
    cos.view(-1)[::7] = 1.0
    mask = (torch.rand((shape[0], shape[2]), generator=g, device="cuda")
            > 0.25).float()
    mask[0] = 0.0
    got = knrm_pool_kernel(cos, mask)
    torch.testing.assert_close(got, knrm_pool_ref(cos, mask), **TOL)
    assert torch.equal(knrm_pool_kernel(_misaligned(cos), _misaligned(mask)),
                       got)


@pytest.mark.parametrize("layout", ["k1", "k4"])
def test_engine_on_cuda_matches_cpu(layout):
    _require_cuda()
    cpu, gpu = _index(layout, "cpu"), _index(layout, "cuda")
    params = get_retriever("knrm").init(torch.Generator().manual_seed(0),
                                        cpu.n_b, cpu.functions, device="cpu")
    e_cpu = SeineEngine(cpu, "knrm", params)
    e_gpu = SeineEngine(gpu, "knrm", copy.deepcopy(params))
    q = np.array([0, 3, 7, -1, 12, 1000], np.int32)
    docs = np.arange(-1, cpu.n_docs + 2, dtype=np.int32)
    torch.testing.assert_close(e_gpu.score(q, docs).cpu(),
                               e_cpu.score(q, docs), **TOL)
    for doc_block in (None, 16):
        s_g, d_g = e_gpu.retrieve(q, 10, doc_block=doc_block)
        s_c, d_c = e_cpu.retrieve(q, 10, doc_block=doc_block)
        assert torch.equal(d_g.cpu(), d_c)
        torch.testing.assert_close(s_g.cpu(), s_c, **TOL)


def _packed_layout(layout, device):
    if layout == "adversarial":
        return adversarial_index(device=device)
    if layout == "k1":
        return partition_index(_index("k1", device), 1)
    return _index("k4", device)


def _scan_packed(p, q, blo, block):
    lo, hi = retrieve_lanes(q, p.term_offsets, p.term_to_shard, p.range_lo,
                            p.range_hi, p.nmax)
    scale = (None if p.value_scale is None
             else lane_scales(p.value_scale, p.range_lo, q).contiguous())
    return retrieve_windows_packed_kernel(
        p._packed(), p.fences, p._serve_values, scale,
        lo.to(torch.int32).contiguous(), hi.to(torch.int32).contiguous(),
        blo, block, tile=p.codec_tile)


@pytest.mark.parametrize("codec", ["packed", "packed-q8"])
@pytest.mark.parametrize("layout", ["k1", "k4", "adversarial"])
def test_packed_kernels_match_plain(layout, codec):
    """Both packed kernels == their plain versions on the same packed
    index, at three codec tiles; per-term routing (k1), per-pair routing
    of a split hot term (k4), and 32-bit tiles of words with the top bit
    set (adversarial)."""
    _require_cuda()
    cpu_raw, gpu_raw = _packed_layout(layout, "cpu"), _packed_layout(
        layout, "cuda")
    if layout == "adversarial":
        q, docs = adversarial_queries(cpu_raw)
        blocks = ((256, -(1 << 31)), (64, -8), (256, 1000),
                  (256, (1 << 31) - 300))
    else:
        q = torch.tensor([0, 1, 17, -1, 45, 39, 3, 1000], dtype=torch.int32)
        docs = torch.arange(-2, cpu_raw.n_docs + 3, dtype=torch.int32)
        blocks = ((64, 0), (16, 48), (7, 3), (1024, 0))
    before = csr_lookup_packed_kernel.launches
    for tile in (8, 64, 256):
        cpu, gpu = (pack_index(cpu_raw, codec, tile=tile),
                    pack_index(gpu_raw, codec, tile=tile))
        want = cpu.qd_matrix(q, docs, impl="kernel")
        got = gpu.qd_matrix(q.cuda(), docs.cuda())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), f"tile={tile}"
        if codec == "packed":
            assert torch.equal(want, cpu_raw.qd_matrix(q, docs))
        for block, blo in blocks:
            got = _scan_packed(gpu, q.cuda(), blo, block)
            want = _scan_packed(cpu, q, blo, block)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (tile, block, blo)
    assert csr_lookup_packed_kernel.launches == before + 3


def _packed_lookup_case(layout):
    """(raw partition on the card, query, docs) of the packed lookup
    kernel's tests: the k1 and k4 indexes (per term; per pair on the
    split hot term), the deep index split at K = 4 (ranges of 2,285
    postings: two fence rounds at tile 8; docs on tile edges), and the
    adversarial ids (c = 0 and c = 32 tiles, top-bit words)."""
    if layout == "adversarial":
        raw = adversarial_index(device="cuda")
        q, docs = adversarial_queries(raw)
        return raw, q.cuda(), docs.cuda()
    if layout == "deep":
        idx, q, docs = _lookup_case("deep")
        return partition_index(idx, 4), q, docs
    raw = _packed_layout(layout, "cuda")
    q = torch.tensor([0, 1, 17, -1, 45, 39, 3, 1000], dtype=torch.int32,
                     device="cuda")
    return raw, q, torch.arange(-2, raw.n_docs + 3, dtype=torch.int32,
                                device="cuda")


def _packed_routed(p, q, docs):
    """The packed lookup wrapper's arguments, routed as ``ops.csr_lookup``
    routes a request (per term, or per pair where a hot term is split)
    and as ``ops.csr_lookup_pairs`` routes the coalesced (1, P) grid of
    the same pairs: [(args, (B, Q) view of the output)]."""
    i32 = lambda a: a.to(torch.int32).contiguous()  # noqa: E731

    def args(k, lo, hi, w, d):
        scale = (None if p.value_scale is None else
                 _lane_scale(p.value_scale, p.range_lo, k, w).contiguous())
        return (i32(k), i32(lo), i32(hi), i32(d), p._packed(), p.fences,
                p._serve_values, scale)
    grid = args(*_route_cells(q, docs, p.term_offsets, p.term_to_shard,
                              p.range_lo, p.split_term, p.split_doc), docs)
    shape = (q.shape[0], docs.shape[0])
    terms = q[:, None].expand(shape).reshape(1, -1)
    pair_d = docs[None].expand(shape).reshape(-1)
    pairs = args(*_route(terms, pair_d[None], p.term_offsets,
                         p.term_to_shard, p.range_lo, p.split_term,
                         p.split_doc), terms, pair_d)
    return [(grid, lambda m: m),
            (pairs, lambda m: m[:, 0].view(shape + m.shape[2:])
             .transpose(0, 1))]


@pytest.mark.parametrize("codec", ["packed", "packed-q8"])
@pytest.mark.parametrize("layout", ["k1", "k4", "deep", "adversarial"])
def test_packed_lookup_kernel_matches_plain_per_term_and_per_pair_grid(
        layout, codec):
    """The packed lookup kernel against its plain version, both on the
    card, bit for bit (sign of zero included), at codec tiles 8, 64 and
    256: routed per request (per term, or per pair on a split hot term)
    and as the coalesced (1, P) grid, each pair routed on its own; both
    equal the request's M.  A words buffer and a values buffer that start
    off a 16-byte boundary (the row then moves one element at a time: the
    row path takes vectors only when values and M are both aligned; M is
    the wrapper's own allocation) give the same bits, and
    ``csr_lookup_pairs`` (``index.lookup_pair_rows``) runs the same (1, P)
    grid."""
    _require_cuda()
    raw, q, docs = _packed_lookup_case(layout)
    before = csr_lookup_packed_kernel.launches
    for tile in (8, 64, 256):
        p = pack_index(raw, codec, tile=tile)
        m = p.qd_matrix(q, docs)
        for args, as_m in _packed_routed(p, q, docs):
            got = csr_lookup_packed_kernel(*args, tile=tile)
            want = csr_lookup_packed_plain(*args, tile=tile)
            assert torch.equal(got, want), (tile, args[0].shape)
            assert torch.equal(got.signbit(), want.signbit())
            assert torch.equal(as_m(got), m), (tile, args[0].shape)
            words, *meta = args[4]
            mis = csr_lookup_packed_kernel(
                *args[:4], (_misaligned(words), *meta), args[5],
                _misaligned(args[6]), args[7], tile=tile)
            assert torch.equal(mis, want) and torch.equal(
                mis.signbit(), want.signbit()), (tile, "misaligned")
        shape = (q.shape[0], docs.shape[0])
        pairs = p.lookup_pair_rows(q[:, None].expand(shape).reshape(-1),
                                   docs[None].expand(shape).reshape(-1))
        assert torch.equal(pairs.view(shape + pairs.shape[1:])
                           .transpose(0, 1), m), (tile, "csr_lookup_pairs")
    assert csr_lookup_packed_kernel.launches == before + 3 * 6
    assert (m != 0).any() and (m == 0).any()


@pytest.mark.parametrize("codec", ["packed", "packed-q8"])
def test_packed_engine_on_cuda_matches_cpu(codec):
    _require_cuda()
    cpu, gpu = _index("k1", "cpu"), _index("k1", "cuda")
    params = get_retriever("knrm").init(torch.Generator().manual_seed(0),
                                        cpu.n_b, cpu.functions, device="cpu")
    kw = dict(partition="term", n_shards=2, codec=codec, codec_tile=64)
    e_cpu = SeineEngine(cpu, "knrm", params, **kw)
    e_gpu = SeineEngine(gpu, "knrm", copy.deepcopy(params), **kw)
    q = np.array([0, 3, 7, -1, 12, 1000], np.int32)
    docs = np.arange(-1, cpu.n_docs + 2, dtype=np.int32)
    torch.testing.assert_close(e_gpu.score(q, docs).cpu(),
                               e_cpu.score(q, docs), **TOL)
    for doc_block in (None, 16):
        s_g, d_g = e_gpu.retrieve(q, 10, doc_block=doc_block)
        s_c, d_c = e_cpu.retrieve(q, 10, doc_block=doc_block)
        assert torch.equal(d_g.cpu(), d_c)
        torch.testing.assert_close(s_g.cpu(), s_c, **TOL)


def _scan_layout(layout, codec, device, tile=8):
    """(index, query, [(origin, block, n_blocks)]) of one scan case: the
    k1 and k4 indexes scanned whole, or the adversarial ids in lone blocks
    at both ends of the int32 range."""
    raw = _packed_layout(layout, device)
    if codec != "none":
        raw = pack_index(raw, codec, tile=tile)
    if layout == "adversarial":
        q, _ = adversarial_queries(adversarial_index())
        scans = [(-(1 << 31), 256, 1), (-8, 64, 1), (1000, 256, 1),
                 ((1 << 31) - 300, 256, 1), (40_003, 7, 1)]
    else:
        q = torch.tensor([0, 1, 17, -1, 45, 39, 3, 1000], dtype=torch.int32)
        scans = [(0, b, -(-raw.n_docs // b)) for b in (1, 7, 16, 64, 1024)]
        scans.append((3, 5, 2))
    return raw, q.to(device), scans


def _scan_with_table(p, codec, q, origin, block, n_blocks):
    """(the scan's table, M of each of its blocks, the per-block
    reference's M), as the ops run the scan."""
    lo, hi = retrieve_lanes(q, p.term_offsets, p.term_to_shard, p.range_lo,
                            p.range_hi, p.nmax)
    lo, hi = lo.to(torch.int32).contiguous(), hi.to(torch.int32).contiguous()
    blocks = [origin + b * block for b in range(n_blocks)]
    if codec == "none":
        bounds = lane_bounds_kernel(p.doc_ids, lo, hi, origin, block,
                                    n_blocks)
        return bounds, [retrieve_windows_kernel(
            p.doc_ids, p.values, lo, hi, blo, block, bounds=bounds)
            for blo in blocks], [scan_block_ref(
                p.doc_ids, p.values, lo, hi, blo, block) for blo in blocks]
    scale = (None if p.value_scale is None
             else lane_scales(p.value_scale, p.range_lo, q).contiguous())
    args = (p._packed(), p.fences, p._serve_values)
    bounds = lane_bounds_packed_kernel(*args, lo, hi, origin, block,
                                       n_blocks, tile=p.codec_tile)
    return bounds, [retrieve_windows_packed_kernel(
        *args, scale, lo, hi, blo, block, tile=p.codec_tile, bounds=bounds)
        for blo in blocks], [scan_block_packed_ref(
            *args, scale, lo, hi, blo, block, tile=p.codec_tile)
            for blo in blocks]


@pytest.mark.parametrize("codec,tile", [("none", 8), ("packed", 8),
                                        ("packed", 64), ("packed-q8", 8),
                                        ("packed-q8", 64)])
@pytest.mark.parametrize("layout", ["k1", "k4", "adversarial"])
def test_scan_kernels_match_plain_over_every_block(layout, codec, tile):
    """The lane-bounds table and every block's M on the card == their
    plain versions (the same wrappers on the CPU) bit for bit, and M ==
    the independent per-block reference (``scan_block_ref`` /
    ``scan_block_packed_ref``): blocks of 1, 5 and 7 docs (CTAs of fewer
    than 4 docs, partial last blocks), 16, 64 and 1,024, empty lanes and
    a -1 slot, codec tiles 8 and 64, rows of 36 floats (16-byte vectors;
    k1) and of 18 and 6 (scalar; k4, adversarial), top-bit words and
    int32-extreme blocks.  The launch counts rise by one table per scan
    and one per block."""
    _require_cuda()
    cpu, q_cpu, scans = _scan_layout(layout, codec, "cpu", tile)
    gpu, q, _ = _scan_layout(layout, codec, "cuda", tile)
    counters = ((lane_bounds_kernel, retrieve_windows_kernel)
                if codec == "none" else
                (lane_bounds_packed_kernel, retrieve_windows_packed_kernel))
    for origin, block, n_blocks in scans:
        before = [c.launches for c in counters]
        bounds, got, ref = _scan_with_table(gpu, codec, q, origin, block,
                                            n_blocks)
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == [
            1, n_blocks]
        want_bounds, want, _ = _scan_with_table(cpu, codec, q_cpu, origin,
                                                block, n_blocks)
        assert torch.equal(bounds.table.cpu(), want_bounds.table), (
            origin, block)
        for b, (g, w, r) in enumerate(zip(got, want, ref)):
            assert torch.equal(g.cpu(), w), (origin, block, b)
            assert torch.equal(g, r), (origin, block, b)


@pytest.mark.parametrize("codec", ["none", "packed", "packed-q8"])
def test_scan_kernels_at_a_wide_query(codec):
    """80 query slots (320 cells x K = 4 lanes per CTA: more pairs and
    row vectors than a CTA has threads, the loops take several rounds):
    every block == the per-block reference, bitwise."""
    _require_cuda()
    p = _index("k4", "cuda")
    if codec != "none":
        p = pack_index(p, codec, tile=8)
    q = torch.arange(-5, 75, dtype=torch.int32, device="cuda")
    _, got, ref = _scan_with_table(p, codec, q, 0, 16, -(-p.n_docs // 16))
    for b, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), b


def test_scan_writes_m_without_a_memset():
    """Every cell of M is written by the block kernel: a scan of the K=4
    fixture on the card records no memset, and a block's M does not
    depend on what its buffer held (the output is ``torch.empty``; the
    caching allocator hands back the block just freed, filled with NaN
    here)."""
    from torch.profiler import ProfilerActivity, profile
    _require_cuda()
    gpu = _index("k4", "cuda")
    q = torch.tensor([0, 1, 17, -1, 45, 39, 3, 1000], dtype=torch.int32,
                     device="cuda")
    to, dids, vals, t2s, rlo, rhi = _stacked(gpu)
    lo, hi = retrieve_lanes(q, to, t2s, rlo, rhi, dids.shape[1])
    want = scan_block_ref(dids, vals, lo, hi, 0, 64)
    with warnings.catch_warnings():     # the profiler's own notices
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bounds = lane_bounds_kernel(dids, lo, hi, 0, 64)
            torch.full_like(want, float("nan"))  # freed: M reuses its block
            got = retrieve_windows_kernel(dids, vals, lo, hi, 0, 64,
                                          bounds=bounds)
            torch.cuda.synchronize()
    assert torch.equal(got, want)
    names = [e.key for e in prof.key_averages()]
    assert not any("memset" in n.lower() for n in names), names
    assert any("retrieve_block_kernel" in n for n in names), names


def test_quantize_values_on_cuda_matches_numpy():
    """The card's quantiser gives the numpy copy's int8 values and scales
    bit for bit (division, max and rounding, ties included)."""
    _require_cuda()
    rng = np.random.RandomState(0)
    values = (rng.randn(3, 500, 4, 5) * rng.rand(3, 500, 1, 1) * 10
              ).astype(np.float32)
    values[0, :7] = np.float32(127.0 / 2)        # halves round to even
    offs = np.stack([np.r_[0, np.sort(rng.choice(np.arange(1, 480), 40,
                                                  replace=False)), 480 + i]
                     for i in range(3)]).astype(np.int32)
    values[np.arange(500)[None, :] >= offs[:, -1:]] = 0.0   # padding rows
    q, scale = quantize_values(values, offs)
    tq, tscale = quantize_values_torch(torch.from_numpy(values).cuda(),
                                       torch.from_numpy(offs).cuda())
    assert np.array_equal(tq.cpu().numpy(), q)
    assert np.array_equal(tscale.cpu().numpy(), scale)


SEG_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,u,length,de,n_seg", [
    (32, 512, 512, 128, 20),     # a build batch
    (3, 70, 130, 200, 64),       # S = 64, De not a multiple of 32
    (2, 5, 9, 37, 3),            # fewer terms and tokens than one tile
    (1000, 6, 160, 32, 5),       # the No-Index shape
])
def test_seg_interact_kernel_matches_plain(b, u, length, de, n_seg):
    """Pad terms, tokens outside [0, S), an empty segment; every (term,
    segment) cell within the bar of the plain version, zeros for pad
    terms and the empty segment, and the same bits run to run."""
    _require_cuda()
    g = torch.Generator().manual_seed(b + u + de)
    e_term = torch.randn(b, u, de, generator=g) / de ** 0.5
    e_tok = torch.randn(b, length, de, generator=g) / de ** 0.5
    seg = torch.sort(torch.randint(-1, n_seg + 1, (b, length), generator=g),
                     dim=1).values.to(torch.int32)
    seg[:, ::7] = -1
    if n_seg > 1:
        seg[seg == 1] = 0                      # segment 1 is empty
    term_ids = torch.randint(0, 1000, (b, u), generator=g,
                             dtype=torch.int32)
    term_ids[torch.rand(b, u, generator=g) < 0.3] = -1
    args = [x.cuda().contiguous() for x in (e_term, e_tok, seg, term_ids)]
    before = seg_interact_kernel.launches
    got = seg_interact_kernel(*args, n_seg)
    again = seg_interact_kernel(*args, n_seg)
    torch.cuda.synchronize()
    assert seg_interact_kernel.launches == before + 2
    want = seg_interact_plain(*args, n_seg)      # on the card: see TOL
    torch.testing.assert_close(got, want, **SEG_TOL)
    assert torch.equal(got, again)
    assert (got[term_ids.cuda() < 0] == 0).all()
    if n_seg > 1:
        assert (got[:, :, 1] == 0).all()


def _seg_case(case):
    """The kernel's inputs on the CPU for one of its edge cases: segments
    that are not contiguous, a segment longer than a token tile (and than
    a fold slice), every token excluded, U across the term tiles, De
    without a 16-byte row (the 4-byte copy path) and at the build's 128,
    S at both ends, docs longer than a compaction window, and a token
    array that does not start on a 16-byte boundary."""
    b, u, length, de, n_seg = dict(
        noncontiguous=(4, 40, 300, 64, 7), long_segment=(3, 33, 512, 128, 3),
        all_excluded=(3, 20, 200, 128, 5), u1=(5, 1, 300, 128, 20),
        u6=(64, 6, 512, 128, 20), u33=(4, 33, 300, 128, 20),
        u512=(4, 512, 512, 128, 20), de1=(4, 40, 300, 1, 20),
        de5=(4, 40, 300, 5, 20), de128=(4, 40, 300, 128, 20),
        s1=(4, 40, 300, 128, 1), s64=(4, 40, 300, 128, 64),
        windows=(2, 20, 2600, 32, 30), unaligned=(3, 20, 200, 128, 10),
    )[case]
    g = torch.Generator().manual_seed(len(case) * 1000 + u + de)
    e_term = torch.randn(b, u, de, generator=g) / de ** 0.5
    e_tok = torch.randn(b, length, de, generator=g) / de ** 0.5
    seg = torch.sort(torch.randint(0, n_seg, (b, length), generator=g),
                     dim=1).values
    if case == "noncontiguous":
        seg = torch.randint(-2, n_seg + 2, (b, length), generator=g)
    if case == "long_segment":
        seg[:, 40:40 + 200] = 1
    seg[torch.rand(b, length, generator=g) < 0.4] = -1
    seg[:, ::13] = n_seg
    if case == "all_excluded":
        seg[0] = -1
        seg[1] = n_seg + 3
    term_ids = torch.randint(0, 1000, (b, u), generator=g, dtype=torch.int32)
    term_ids[torch.rand(b, u, generator=g) < 0.3] = -1
    if case == "u512":
        term_ids[:, 200:] = -1                 # whole tiles of pad terms
    return e_term, e_tok, seg.to(torch.int32), term_ids, n_seg


@pytest.mark.parametrize("case", [
    "noncontiguous", "long_segment", "all_excluded", "u1", "u6", "u33",
    "u512", "de1", "de5", "de128", "s1", "s64", "windows", "unaligned"])
def test_seg_interact_kernel_edge_cases(case):
    """Each case within the bar of the plain version, zeros for pad terms
    and empty segments, and the same bits run to run and from a launch
    with the other term tile (the first 6 terms alone, in tiles of 8, or
    the terms padded to 12 slots, in tiles of 16)."""
    _require_cuda()
    e_term, e_tok, seg, term_ids, n_seg = _seg_case(case)
    args = [x.cuda().contiguous() for x in (e_term, e_tok, seg, term_ids)]
    if case == "unaligned":
        flat = torch.empty(e_tok.numel() + 1, device="cuda")
        args[1] = flat[1:].view(e_tok.shape).copy_(e_tok)
        assert args[1].data_ptr() % 16 and args[1].is_contiguous()
    got = seg_interact_kernel(*args, n_seg)
    if case == "unaligned":                    # 4-byte copies, same bits
        assert torch.equal(got, seg_interact_kernel(
            args[0], e_tok.cuda(), args[2], args[3], n_seg))
    want = seg_interact_plain(*args, n_seg)      # on the card: see TOL
    torch.testing.assert_close(got, want, **SEG_TOL)
    assert (got[term_ids.cuda() < 0] == 0).all()
    empty = ((seg[:, :, None] == torch.arange(n_seg)).sum(1) == 0).cuda()
    assert (got.permute(0, 2, 1, 3)[empty] == 0).all()
    assert torch.equal(got, seg_interact_kernel(*args, n_seg))
    n_u = term_ids.shape[1]
    if n_u > 8:
        other = seg_interact_kernel(args[0][:, :6].contiguous(), args[1],
                                    args[2], args[3][:, :6].contiguous(),
                                    n_seg)
        assert torch.equal(other, got[:, :6])
    else:
        pad = torch.full((term_ids.shape[0], 12 - n_u), -1,
                         dtype=torch.int32, device="cuda")
        other = seg_interact_kernel(
            torch.cat([args[0], torch.zeros_like(args[0][:, :1]).expand(
                -1, 12 - n_u, -1)], 1).contiguous(), args[1], args[2],
            torch.cat([args[3], pad], 1), n_seg)
        assert torch.equal(other[:, :n_u], got)


def test_seg_interact_build_and_query_cells_are_the_same_bits():
    """The same doc's cells from a build batch (U = 512 slots, ~180 live)
    and from a No-Index query (U = 6 slots, the doc at another index of
    another batch) are the same bits: indexed == No-Index at |diff| 0."""
    _require_cuda()
    g = torch.Generator().manual_seed(5)
    b, u, length, de, n_seg = 8, 512, 512, 128, 20
    e_tok = torch.randn(b, length, de, generator=g) / de ** 0.5
    seg = torch.sort(torch.randint(0, n_seg, (b, length), generator=g),
                     dim=1).values
    seg[torch.rand(b, length, generator=g) < 0.6] = -1
    seg = seg.to(torch.int32)
    e_term = torch.randn(b, u, de, generator=g) / de ** 0.5
    term_ids = torch.arange(b * u, dtype=torch.int32).reshape(b, u)
    term_ids[:, 180:] = -1
    build = seg_interact_kernel(
        *(x.cuda().contiguous() for x in (e_term, e_tok, seg, term_ids)),
        n_seg)
    for d in range(b):
        slots = torch.tensor([3, 170, 0, 179, 64])
        q_term = torch.zeros(3, 6, de)
        q_term[2, :5] = e_term[d, slots]
        q_ids = torch.full((3, 6), 1, dtype=torch.int32)
        q_ids[2, 5] = -1
        q_tok = torch.stack([e_tok[(d + 1) % b], e_tok[(d + 2) % b],
                             e_tok[d]])
        q_seg = torch.stack([seg[(d + 1) % b], seg[(d + 2) % b], seg[d]])
        query = seg_interact_kernel(
            *(x.cuda().contiguous() for x in (q_term, q_tok, q_seg, q_ids)),
            n_seg)
        assert torch.equal(query[2, :5], build[d, slots.cuda()])
        assert (query[2, 5] == 0).all()


def test_seg_interact_jax_signature_on_cuda():
    _require_cuda()
    g = torch.Generator().manual_seed(0)
    for v, n_seg, ls, de in ((64, 4, 128, 32), (128, 2, 128, 200)):
        ev = torch.randn(v, de, generator=g) / de ** 0.5
        st = torch.randn(n_seg, ls, de, generator=g) / de ** 0.5
        mask = torch.ones(n_seg, ls)
        mask[-1] = 0.0
        got = seg_interact(ev.cuda(), st.cuda(), mask.cuda())
        torch.testing.assert_close(got.cpu(), seg_interact(ev, st, mask),
                                   **SEG_TOL)
        assert (got[:, -1] == 0).all()


@pytest.mark.parametrize("v,n_seg,ls,de", [
    (64, 4, 128, 32), (300, 7, 256, 128), (256, 3, 128, 64),
    (128, 2, 128, 200)])
def test_seg_interact_unit_scale_on_cuda(v, n_seg, ls, de):
    """The reference test's unit-scale rows over its shape sweep, at its
    kernel-vs-index bar (rtol 1e-3 / atol 1e-4): the segment sums reach
    hundreds, and the kernel's FMA order and the plain bmm's part by more
    than rtol 1e-4 there."""
    _require_cuda()
    g = torch.Generator().manual_seed(v * n_seg + de)
    ev = torch.randn(v, de, generator=g)
    st = torch.randn(n_seg, ls, de, generator=g)
    lens = torch.randint(0, ls + 1, (n_seg,), generator=g)
    lens[-1] = 0
    mask = (torch.arange(ls)[None] < lens[:, None]).float()
    got = seg_interact(ev.cuda(), st.cuda(), mask.cuda())
    torch.testing.assert_close(got.cpu(), seg_interact(ev, st, mask),
                               rtol=1e-3, atol=1e-4)
    assert (got[:, -1] == 0).all()


def _small_build(device, n_docs=64):
    cfg = dataclasses.replace(seine_smoke(), n_docs=n_docs)
    ds = generate(cfg, seed=0)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens,
                             keep_frac=cfg.vocab_keep_frac)
    toks, segs = segment_corpus([vocab.map_tokens(d) for d in ds.docs],
                                cfg.n_segments, max_len=160)
    provider = HashProvider(vocab.size, cfg.embed_dim, seed=0,
                            device=device)
    builder = IndexBuilder(cfg, vocab, provider,
                           ip=init_interaction_params(None, cfg.embed_dim),
                           device=device)
    return builder, toks, segs


def test_build_on_cuda_matches_cpu():
    """A 64-doc build on the card against the same build on the CPU: ids
    bitwise, values within the bar; then indexed == No-Index on the
    card, and the No-Index engine against the CPU's."""
    _require_cuda()
    b_cpu, toks, segs = _small_build("cpu")
    b_gpu, _, _ = _small_build("cuda")
    before = seg_interact_kernel.launches
    for k in (1, 2):
        cpu = b_cpu.build_partitioned(toks, segs, k, batch_size=16)
        gpu = b_gpu.build_partitioned(toks, segs, k, batch_size=16)
        for n in ("term_offsets", "doc_ids", "fences", "term_to_shard",
                  "range_lo", "range_hi", "idf", "doc_len", "seg_len"):
            assert torch.equal(getattr(gpu, n).cpu(), getattr(cpu, n)), n
        torch.testing.assert_close(gpu.values.cpu(), cpu.values, **SEG_TOL)
    assert seg_interact_kernel.launches == before + 2 * 4
    params = get_retriever("knrm").init(torch.Generator().manual_seed(0),
                                        cpu.n_b, cpu.functions, device="cpu")
    n_cpu = NoIndexEngine(b_cpu, cpu, toks, segs, "knrm", params)
    n_gpu = NoIndexEngine(b_gpu, gpu, toks, segs, "knrm",
                          copy.deepcopy(params))
    idx_gpu = SeineEngine(gpu, "knrm", copy.deepcopy(params))
    q = np.array([int(toks[3][toks[3] >= 0][0]), 5, -1, 40, 1000, 7],
                 np.int32)
    docs = np.arange(-1, 66, dtype=np.int32)
    torch.testing.assert_close(n_gpu.score(q, docs).cpu(),
                               n_cpu.score(q, docs), **SEG_TOL)
    ok = slice(1, 65)
    torch.testing.assert_close(n_gpu.score(q, docs)[ok],
                               idx_gpu.score(q, docs)[ok], **SEG_TOL)
    on_fly = n_gpu.qd_matrix(q, docs[ok])
    looked = gpu.qd_matrix(torch.from_numpy(q).cuda(),
                           torch.from_numpy(docs[ok]).cuda())
    assert (on_fly - looked).abs().max().item() <= 1e-5


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_attn_kernel_matches_plain(hd, dtype, causal):
    """Every head width and type the kernel takes, at sequence lengths
    that are not multiples of the 64-row tile (the tail is masked), one
    query, Sq != Skv and a group of 3."""
    _require_cuda()
    dt = getattr(torch, dtype)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-5)
    g = torch.Generator().manual_seed(hd)
    for b, sq, skv, hq, hkv in ((2, 100, 100, 6, 2), (3, 1, 1, 4, 4),
                                (1, 70, 130, 3, 1), (2, 129, 129, 8, 8)):
        q = torch.randn(b, sq, hq, hd, generator=g).to(dt)
        k = torch.randn(b, skv, hkv, hd, generator=g).to(dt)
        v = torch.randn(b, skv, hkv, hd, generator=g).to(dt)
        before = flash_attn_kernel.launches
        got = flash_attention(q.cuda(), k.cuda(), v.cuda(), causal=causal)
        torch.cuda.synchronize()
        assert flash_attn_kernel.launches == before + 1
        assert got.dtype == dt and got.shape == q.shape
        # the plain version on the card: see TOL
        want = flash_attn_plain(q.cuda(), k.cuda(), v.cuda(), causal=causal)
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_attn_wgmma_matches_plain(hd, causal):
    """The bf16 wgmma kernel at lengths that are not multiples of the
    64-key tile or the 64-row block (a tail of one row, Sq < Skv, Sq >
    Skv), with a group of 3, at 2e-2; its rows do not depend on the rest
    of the batch (bitwise run to run and against one doc alone)."""
    _require_cuda()
    g = torch.Generator().manual_seed(hd)
    for b, sq, skv, hq, hkv in ((2, 160, 160, 6, 2), (1, 65, 65, 2, 2),
                                (2, 129, 200, 3, 1), (1, 200, 96, 4, 4)):
        q = torch.randn(b, sq, hq, hd, generator=g).bfloat16()
        k = torch.randn(b, skv, hkv, hd, generator=g).bfloat16()
        v = torch.randn(b, skv, hkv, hd, generator=g).bfloat16()
        args = (q.cuda(), k.cuda(), v.cuda())
        got = flash_attn_kernel(*args, causal=causal)
        again = flash_attn_kernel(*args, causal=causal)
        alone = flash_attn_kernel(*(x[-1:] for x in args), causal=causal)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        assert torch.equal(got, again) and torch.equal(got[-1:], alone)
        want = flash_attn_plain(q, k, v, causal=causal)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=2e-2, atol=2e-2)


# scripts/flash_attn_fwd_digest.py: the bf16 digests on the tree before
# the forward kernel could write an lse (commit bd5bb5a), the float32 one
# on the tree that moved the float32 kernel to split TF32 on wgmma; both
# on an NVIDIA H100 80GB HBM3 at 700.00 W
FWD_DIGESTS = {
    "(32, 512, 24, 8, 128) bfloat16 causal=True": "4a875c2d48519c2b",
    "(4, 512, 24, 8, 64) bfloat16 causal=True": "8a973279f3b8f2a9",
    "(2, 200, 6, 2, 64) bfloat16 causal=False": "9dbc4ca903eface6",
    "(2, 200, 6, 2, 128) float32 causal=True": "d5ad6de2f0fdeaaf"}


def test_flash_attn_forward_keeps_its_bits():
    """The forward kernel without an lse (serving, the build, decode's
    prefill) gives the bits the tree before the lse gave at the LM
    build's shape and hd 64 in bf16, and the float32 (split TF32) kernel
    the bits it gave when it was written."""
    _require_cuda()
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "flash_attn_fwd_digest", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts", "flash_attn_fwd_digest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.digests(flash_attn_kernel) == FWD_DIGESTS


# scripts/flash_attn_bwd_digest.py on the tree that moved the float32
# backward to split TF32 on wgmma (NVIDIA H100 80GB HBM3, 700.00 W)
BWD_DIGESTS = {
    "(2, 100, 100, 6, 2, 64) causal=True": "cc4d9d0972160f1c",
    "(1, 130, 70, 4, 1, 16) causal=False": "e76a48bd085583c9",
    "(2, 129, 129, 8, 2, 32) causal=True": "406cfd9e90a5bda5",
    "(1, 200, 200, 4, 4, 128) causal=True": "a29c79e177556b30",
    "(1, 70, 130, 3, 1, 64) causal=True": "2257a7cb9321d2a5"}


def test_flash_attn_backward_keeps_its_float32_bits():
    """The backward kernel's float32 instances (split TF32 on wgmma) give
    the bits they gave when they were written, over tail lengths, Sq !=
    Skv both ways, groups of 1, 3 and 4 and every head width."""
    _require_cuda()
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "flash_attn_bwd_digest", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts", "flash_attn_bwd_digest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.digests(flash_attn_bwd_kernel) == BWD_DIGESTS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_attn_backward_kernel_matches_plain(hd, causal, dtype):
    """The backward kernel against its plain version on the card, from
    the forward kernel's o and lse, at lengths that are not multiples of
    the 64-row tile, one query, Sq != Skv both ways, and GQA groups of 1,
    3 and 4: float32 at rtol 1e-4 / atol 1e-5, bf16 with at most 0.1% of
    the values past 2e-2 (row 8's bar).  At hd 64 and 128 also lengths
    that are tile multiples, whose rings wrap around many times (16 KV
    tiles a query tile; 4 heads x 16 query tiles a key tile).  Two
    launches give the same bits, the forward's o is the same with and
    without its lse, and one call counts one launch."""
    _require_cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(hd + int(causal))
    cases = [(2, 100, 100, 6, 2), (3, 1, 1, 4, 4), (1, 70, 130, 3, 1),
             (2, 129, 129, 8, 2), (1, 130, 70, 4, 1)]
    cases += {64: [(2, 1024, 1024, 8, 2)],
              128: [(1, 256, 256, 4, 1)]}.get(hd, [])
    for b, sq, skv, hq, hkv in cases:
        q, do = (torch.randn(b, sq, hq, hd, generator=g).to(dt).cuda()
                 for _ in range(2))
        k, v = (torch.randn(b, skv, hkv, hd, generator=g).to(dt).cuda()
                for _ in range(2))
        o, lse = flash_attn_kernel(q, k, v, causal=causal, return_lse=True)
        assert torch.equal(o, flash_attn_kernel(q, k, v, causal=causal))
        _, want_lse = flash_attn_plain(q, k, v, causal=causal,
                                       return_lse=True)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)
        before = flash_attn_bwd_kernel.launches
        got = flash_attn_bwd_kernel(q, k, v, o, do, lse, causal=causal)
        again = flash_attn_bwd_kernel(q, k, v, o, do, lse, causal=causal)
        torch.cuda.synchronize()
        assert flash_attn_bwd_kernel.launches == before + 2
        want = flash_attn_bwd_plain(q, k, v, o, do, lse, causal=causal)
        for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
            assert a.dtype == dt and a.shape == w.shape, name
            assert torch.equal(a, a2), name
            a, w = a.float(), w.float()
            if dtype == "float32":
                torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5,
                                           msg=name)
            else:
                past = ((a - w).abs() > 2e-2 + 2e-2 * w.abs()).float()
                assert past.mean().item() <= 1e-3, name


def test_flash_attention_autograd_runs_both_kernels():
    """``flash_attention`` under autograd on CUDA tensors: one forward
    launch with lse and one backward launch per call, gradients equal
    to the plain Function's on the card (float32 bar)."""
    _require_cuda()
    from repro_torch.kernels.flash_attn import flash_attention_plain
    g = torch.Generator().manual_seed(0)
    x = [torch.randn(2, 150, h, 64, generator=g).cuda() for h in (6, 2, 2)]
    do = torch.randn(2, 150, 6, 64, generator=g).cuda()
    grads = []
    for attention in (flash_attention, flash_attention_plain):
        q, k, v = (t.clone().requires_grad_() for t in x)
        before = (flash_attn_kernel.launches, flash_attn_bwd_kernel.launches)
        grads.append(torch.autograd.grad(attention(q, k, v), (q, k, v), do))
        after = (flash_attn_kernel.launches, flash_attn_bwd_kernel.launches)
        assert [a - b for a, b in zip(after, before)] == (
            [1, 1] if attention is flash_attention else [0, 0])
    for a, w in zip(*grads):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["stablelm-1.6b", "granite-moe-3b-a800m"])
def test_lm_training_steps_on_cuda_match_cpu(name):
    """Three ``fit_lm`` steps of the float32 smoke config on the card
    (the kernels, remat, the chunked loss) against the same steps on the
    CPU (the plain versions) from the same weights: loss and gradient
    norm per step at rtol 1e-4 / atol 1e-5."""
    _require_cuda()
    from repro_torch.launch import train as train_cli
    cfg = smoke(name)
    cpu = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict)
               else v.cuda()) for k, v in cpu.items()}
    before = flash_attn_bwd_kernel.launches
    runs = [train_cli.fit_lm(cfg, p, (4, 96), 3, None, verbose=False)
            for p in (gpu, cpu)]
    assert flash_attn_bwd_kernel.launches == before + 3 * cfg.n_layers
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in runs[0].history],
                                   [h[key] for h in runs[1].history],
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_flash_attn_kernel_refuses_what_it_does_not_take():
    _require_cuda()
    q = torch.zeros(1, 8, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attn_kernel(q, q, q)
    h = torch.zeros(1, 8, 2, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attn_kernel(h, h, h)
    f = torch.zeros(1, 8, 2, 64, device="cuda")
    with pytest.raises(TypeError):
        flash_attn_kernel(f, f.bfloat16(), f.bfloat16())


def _on(params, device):
    return {k: ({n: t.to(device) for n, t in v.items()}
                if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("name", ["minitron-4b", "stablelm-1.6b"])
def test_bf16_lm_forward_on_cuda_matches_cpu(name, head_dim, seed):
    """The smoke LM in bf16 through the wgmma kernel on the card against
    the same forward on the CPU through the plain attention: two layers,
    300 tokens (four key tiles and a tail), at the smoke width's head_dim
    16 and the build's 128.  At most 0.1% of the hidden values lie past
    the port's bf16 bar against the JAX model, 2e-2
    (tests/test_torch_transformer.py).  The plain attention on the card
    reads up to ~0.05% there (the card's bf16 GEMMs round other values
    than the CPU's), and an attention that rounds p to bf16 before
    P . V 0.35-0.85% (scripts/flash_attn_precision.py)."""
    _require_cuda()
    c = dataclasses.replace(smoke(name), dtype="bfloat16",
                            head_dim=head_dim)
    params = T.init_params(c, torch.Generator().manual_seed(seed),
                           device="cpu")
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, c.vocab_size, (3, 300)).astype(np.int32))
    want, _ = T.forward(params, toks, c)
    before = flash_attn_kernel.launches
    got, _ = T.forward(_on(params, "cuda"), toks.cuda(), c)
    torch.cuda.synchronize()
    assert flash_attn_kernel.launches == before + c.n_layers
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got, want = got.cpu().float(), want.float()
    assert torch.isfinite(got).all()
    past = (got - want).abs() > 2e-2 + 2e-2 * want.abs()
    assert past.float().mean().item() <= 1e-3


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b"])
def test_moe_forward_on_cuda_matches_cpu(name, monkeypatch):
    """The MoE smoke LMs in float32 (TF32 off) on the card, through
    flash_attn, against the same forward on the CPU: hidden states and
    the summed aux loss at rtol 1e-4 / atol 1e-5, at the published
    capacity factor 1.25 (pairs drop) and the smoke's dropless 8."""
    _require_cuda()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for cf in (1.25, 8.0):
        c = smoke(name)
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf))
        params = T.init_params(c, torch.Generator().manual_seed(3),
                               device="cpu")
        toks = torch.from_numpy(np.random.RandomState(3).randint(
            0, c.vocab_size, (4, 200)).astype(np.int32))
        want, want_aux = T.forward(params, toks, c)
        before = flash_attn_kernel.launches
        got, aux = T.forward(_on(params, "cuda"), toks.cuda(), c)
        torch.cuda.synchronize()
        assert flash_attn_kernel.launches == before + c.n_layers
        torch.testing.assert_close(got.cpu(), want, **SEG_TOL)
        torch.testing.assert_close(aux.cpu(), want_aux, **SEG_TOL)


@pytest.mark.parametrize("name", ["minitron-4b", "granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b"])
def test_decode_on_cuda_matches_cpu(name, monkeypatch):
    """``prefill_cache`` of a 40-token prompt, then 6 ``decode_step``s,
    float32 on the card against the CPU: the logits of every step and
    the cache at rtol 1e-4 / atol 1e-5; the lengths exactly."""
    _require_cuda()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    c = smoke(name)
    params = T.init_params(c, torch.Generator().manual_seed(4),
                           device="cpu")
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, c.vocab_size, (3, 46)).astype(np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        p, t = _on(params, dev), toks.to(dev)
        logits, cache = T.prefill_cache(p, t[:, :40], c, 48)
        steps = [logits]
        for i in range(40, 46):
            logits, cache = T.decode_step(p, cache, t[:, i], c)
            steps.append(logits)
        out[dev] = (torch.stack(steps), cache)
    torch.cuda.synchronize()
    (want, wc), (got, gc) = out["cpu"], out["cuda"]
    torch.testing.assert_close(got.cpu(), want, **SEG_TOL)
    torch.testing.assert_close(gc.k.cpu(), wc.k, **SEG_TOL)
    torch.testing.assert_close(gc.v.cpu(), wc.v, **SEG_TOL)
    assert gc.length.tolist() == wc.length.tolist() == [46] * 3


def _lm_build(device, n_docs=24, name="minitron-4b"):
    cfg = dataclasses.replace(seine_smoke(), n_docs=n_docs)
    ds = generate(cfg, seed=0)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens,
                             keep_frac=cfg.vocab_keep_frac)
    toks, segs = segment_corpus([vocab.map_tokens(d) for d in ds.docs],
                                cfg.n_segments, max_len=160)
    lm = smoke(name)
    params = T.init_params(lm, torch.Generator().manual_seed(0),
                           device=device)
    proj = torch.randn(lm.d_model, cfg.embed_dim,
                       generator=torch.Generator().manual_seed(7))
    provider = LMProvider(lm, params, cfg.embed_dim, proj=proj,
                          device=device)
    builder = IndexBuilder(cfg, vocab, provider,
                           ip=init_interaction_params(None, cfg.embed_dim),
                           device=device)
    return builder, toks, segs


def test_lm_build_on_cuda_matches_cpu(monkeypatch):
    """A smoke-size minitron build (float32, TF32 off) on the card
    through flash_attn against the same build on the CPU: ids bitwise,
    values within rtol 1e-4 / atol 1e-5; flash_attn launched once per
    layer and batch."""
    _require_cuda()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    b_cpu, toks, segs = _lm_build("cpu")
    b_gpu, _, _ = _lm_build("cuda")
    before = flash_attn_kernel.launches
    gpu = b_gpu.build_partitioned(toks, segs, 2, batch_size=8)
    assert flash_attn_kernel.launches == before + 2 * 3
    cpu = b_cpu.build_partitioned(toks, segs, 2, batch_size=8)
    for n in ("term_offsets", "doc_ids", "fences", "term_to_shard",
              "range_lo", "range_hi", "idf", "doc_len", "seg_len"):
        assert torch.equal(getattr(gpu, n).cpu(), getattr(cpu, n)), n
    torch.testing.assert_close(gpu.values.cpu(), cpu.values, **SEG_TOL)


def test_moe_lm_build_on_cuda_matches_cpu(monkeypatch):
    """``test_lm_build_on_cuda_matches_cpu`` over smoke("granite-moe-
    3b-a800m"): each doc routes as its own group on both devices."""
    _require_cuda()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    name = "granite-moe-3b-a800m"
    b_cpu, toks, segs = _lm_build("cpu", name=name)
    b_gpu, _, _ = _lm_build("cuda", name=name)
    before = flash_attn_kernel.launches
    gpu = b_gpu.build_partitioned(toks, segs, 2, batch_size=8)
    assert flash_attn_kernel.launches == before + 2 * 3
    cpu = b_cpu.build_partitioned(toks, segs, 2, batch_size=8)
    for n in ("term_offsets", "doc_ids", "fences"):
        assert torch.equal(getattr(gpu, n).cpu(), getattr(cpu, n)), n
    torch.testing.assert_close(gpu.values.cpu(), cpu.values, **SEG_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,b,maxbag", [(100, 32, 8, 10), (50, 16, 4, 6),
                                          (200, 128, 16, 20), (30, 8, 5, 3),
                                          (9280, 128, 2048, 30)])
def test_embed_bag_kernel_matches_plain(v, d, b, maxbag, dtype):
    """Bitwise: both sum each bag in index order; -1 skipped, ids past
    the table read its last row, empty bags are zeros."""
    _require_cuda()
    rng = np.random.RandomState(v + b)
    lens = rng.randint(0, maxbag, b)
    lens[-1] = 0
    nnz = max(int(lens.sum()), 1)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])[:-1])
    idx = torch.from_numpy(rng.randint(-1, v + 3, nnz).astype(np.int32))
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    ptr = bag_ptr_from_offsets(offsets, nnz, b)
    args = (table.to(dtype).cuda(), idx.cuda(), ptr.cuda())
    got = embed_bag_kernel(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, d)
    assert torch.equal(got, embed_bag_plain(*args))
    assert torch.equal(got.cpu(), embed_bag_plain(table.to(dtype), idx, ptr))
    assert (got[-1] == 0).all()


def test_embed_bag_kernel_refuses_what_it_does_not_take():
    _require_cuda()
    idx = torch.zeros(3, dtype=torch.int32, device="cuda")
    ptr = torch.tensor([0, 3], dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        embed_bag_kernel(torch.zeros(4, 2, dtype=torch.float16,
                                     device="cuda"), idx, ptr)
    with pytest.raises(TypeError, match="int32"):
        embed_bag_kernel(torch.zeros(4, 2, device="cuda"), idx.long(), ptr)
    table = torch.zeros(4, 2, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        embed_bag_kernel(table, idx, ptr)
    with torch.no_grad():
        assert embed_bag_kernel(table, idx, ptr).shape == (1, 2)


def test_embed_bag_kernel_bitwise_at_a_long_bag():
    """One bag of 512 rows (a doc whose tokens share one segment) beside
    short ones: the loads in flight keep the index order, bitwise."""
    _require_cuda()
    rng = np.random.RandomState(5)
    lens = np.array([512, 3, 0, 40, 1])
    nnz = int(lens.sum())
    idx = torch.from_numpy(rng.randint(-1, 9280, nnz).astype(np.int32))
    ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])
                           .astype(np.int32))
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.from_numpy(rng.standard_normal((9280, 128))
                                 .astype(np.float32)).to(dtype)
        got = embed_bag_kernel(table.cuda(), idx.cuda(), ptr.cuda())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), embed_bag_plain(table, idx, ptr))


def _segment_case(case, rng, n_docs=6, n=512, n_bins=64, v=9280):
    """rows and bins (n_docs, n) of one kind of doc: random, with empty
    bins and -1 rows; every token in one bin (a 512-row bag); one token
    per bin; bins past both ends (clamped)."""
    rows = rng.randint(0, v + 3, (n_docs, n))
    if case == "random":
        bins = rng.randint(0, n_bins // 2, (n_docs, n))    # half empty
        rows[rng.rand(n_docs, n) < 0.6] = -1
    elif case == "one_bin":
        bins = np.full((n_docs, n), 7)
    elif case == "one_per_bin":
        bins = np.tile(np.arange(n) % n_bins, (n_docs, 1))
        rows[:, n_bins:] = -1
    else:                                     # out of range
        bins = rng.randint(-5, n_bins + 5, (n_docs, n))
        rows[rng.rand(n_docs, n) < 0.3] = -1
    return torch.from_numpy(rows), torch.from_numpy(bins)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "one_bin", "one_per_bin",
                                  "out_of_range"])
def test_embed_bag_segment_kernel_matches_plain(case, dtype):
    """The segment entry bitwise against its plain version (the stable
    sort into CSR bags, summed in token order), one launch per call."""
    _require_cuda()
    rng = np.random.RandomState(len(case))
    rows, bins = _segment_case(case, rng)
    table = torch.from_numpy(rng.standard_normal((9280, 128))
                             .astype(np.float32)).to(dtype)
    before = embed_bag_kernel.launches
    got = segment_bag_sums(table.cuda(), rows.cuda(), bins.cuda(), 64)
    torch.cuda.synchronize()
    assert embed_bag_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == (6, 64, 128)
    want = segment_bag_sums_plain(table, rows, bins, 64)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, segment_bag_sums_plain(
        table.cuda(), rows.cuda(), bins.cuda(), 64))


def test_embed_bag_segment_kernel_refuses_what_it_does_not_take():
    _require_cuda()
    table = torch.zeros(4, 2, device="cuda")
    rows = torch.zeros(2, 3, dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError, match="int64"):
        embed_bag_segment_kernel(table, rows.int(), rows.int(), 3)
    with pytest.raises(ValueError, match="one shape"):
        embed_bag_segment_kernel(table, rows, rows[:, :2].contiguous(), 3)
    with pytest.raises(TypeError, match="int64"):
        embed_bag_segment_kernel(table, rows, rows.int(), 3)
    with pytest.raises(ValueError, match="n_bins"):
        embed_bag_segment_kernel(table, rows, rows, 0)
    long = torch.zeros(1, 7000, dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="tokens per doc"):
        embed_bag_segment_kernel(table, long, long, 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        embed_bag_segment_kernel(table.half(), rows, rows, 3)


def test_contextualize_on_cuda_matches_cpu():
    """The provider's segment sums through the kernel on the card equal
    the plain version's on the CPU."""
    _require_cuda()
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(-1, 300, (6, 120)).astype(np.int32))
    segs = torch.from_numpy(rng.randint(-2, 70, (6, 120)).astype(np.int32))
    cpu = HashProvider(300, 32, seed=1, device="cpu")
    gpu = HashProvider(300, 32, table=cpu.table(), device="cuda")
    before = embed_bag_kernel.launches
    got = gpu.contextualize(toks.cuda(), segs.cuda())
    assert embed_bag_kernel.launches == before + 1
    torch.testing.assert_close(got.cpu(), cpu.contextualize(toks, segs),
                               **TOL)


@pytest.mark.parametrize("mode", ["naive", "coalesce", "cache"])
def test_frontend_on_cuda_equals_engine_score(mode):
    """The front end on the card: coalesced distinct pairs through the
    lookup kernel (per-pair routing), cached tiles, every future equal
    to engine.score bitwise."""
    _require_cuda()
    idx = load_index(FIXTURE, device="cuda")
    spec = get_retriever("knrm")
    eng = SeineEngine(idx, "knrm", spec.init(
        torch.Generator().manual_seed(0), idx.n_b, idx.functions,
        device="cuda"))
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(-1, 40, 5).astype(np.int32),
             rng.randint(0, idx.n_docs, 16).astype(np.int32))
            for _ in range(10)]
    kw = {"naive": dict(coalesce=False), "coalesce": {},
          "cache": dict(cache_tiles=8)}[mode]
    before = csr_lookup_kernel.launches
    fe = ServingFrontend(eng, max_batch=4, batch_timeout_ms=2, **kw)
    try:
        futs = [fe.submit(q, d) for q, d in reqs]
        for (q, d), f in zip(reqs, futs):
            want = eng.score(q, d).cpu().numpy()
            np.testing.assert_array_equal(f.result(timeout=120), want)
    finally:
        fe.close(timeout=120)
    if mode == "coalesce":
        assert csr_lookup_kernel.launches > before


# -- segment counts past one block or one staging chunk ---------------------

@pytest.mark.parametrize("n_b", [20, 1024, 1025, 2500])
def test_knrm_pool_kernel_takes_any_segment_count(n_b):
    """Past the 1,024 segments a CTA stages at a time the kernel walks the
    segments in chunks and carries each sum across them: one launch per
    call, within the bar of the plain version run on the card, and the
    misaligned copy (scalar staging) gives the same bits."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(n_b)
    shape = (37, 6, n_b)
    cos = torch.rand(shape, generator=g, device="cuda") * 2 - 1
    cos.view(-1)[::7] = 1.0
    mask = (torch.rand((shape[0], n_b), generator=g, device="cuda")
            > 0.25).float()
    mask[0] = 0.0
    before = knrm_pool_kernel.launches
    got = knrm_pool_kernel(cos, mask)
    assert knrm_pool_kernel.launches == before + 1
    torch.testing.assert_close(got, knrm_pool_ref(cos, mask), **TOL)
    assert torch.equal(knrm_pool_kernel(_misaligned(cos), _misaligned(mask)),
                       got)


@pytest.mark.parametrize("n_seg", [20, 64, 65, 128, 130])
def test_seg_interact_kernel_takes_any_segment_count(n_seg):
    """One launch at any segment count, within the bar of the plain
    version, zeros for pad terms and an empty segment, the same bits run
    to run; and each chunk of 64 segments holds the bits of a launch over
    that chunk's segments alone."""
    _require_cuda()
    g = torch.Generator().manual_seed(n_seg)
    b, u, length, de = 4, 40, 700, 64
    e_term = (torch.randn(b, u, de, generator=g) / de ** 0.5).cuda()
    e_tok = (torch.randn(b, length, de, generator=g) / de ** 0.5).cuda()
    seg = torch.sort(torch.randint(-1, n_seg + 1, (b, length), generator=g),
                     dim=1).values
    seg[:, ::7] = -1
    seg[seg == 1] = 0                          # segment 1 is empty
    seg = seg.to(torch.int32).cuda()
    term_ids = torch.randint(0, 1000, (b, u), generator=g, dtype=torch.int32)
    term_ids[torch.rand(b, u, generator=g) < 0.3] = -1
    term_ids = term_ids.cuda()
    before = seg_interact_kernel.launches
    got = seg_interact_kernel(e_term, e_tok, seg, term_ids, n_seg)
    assert seg_interact_kernel.launches == before + 1
    want = seg_interact_plain(e_term, e_tok, seg, term_ids, n_seg)
    torch.testing.assert_close(got, want, **SEG_TOL)
    assert torch.equal(got, seg_interact_kernel(e_term, e_tok, seg,
                                                term_ids, n_seg))
    assert (got[term_ids < 0] == 0).all() and (got[:, :, 1] == 0).all()
    for c0 in range(0, n_seg, 64):
        w = min(64, n_seg - c0)
        local = torch.where((seg >= c0) & (seg < c0 + w), seg - c0, -1)
        part = seg_interact_kernel(e_term, e_tok, local.to(torch.int32),
                                   term_ids, w)
        assert torch.equal(part, got[:, :, c0:c0 + w]), c0


def test_live_index_on_cuda_matches_cpu():
    """A LiveIndex on the card (insert through the build kernels, delete,
    retrieve through the scan with the delta's hook, compact) against the
    same on the CPU: ids bitwise, values within the build's bar, dead
    docs' rows zero and never retrieved."""
    _require_cuda()
    from repro_torch.dist.live import LiveIndex
    n = 96
    b_cpu, toks, segs = _small_build("cpu", n)
    b_gpu, _, _ = _small_build("cuda", n)
    dead = [3, 50, 60]
    lives, launched = {}, {}
    for name, b in (("cpu", b_cpu), ("cuda", b_gpu)):
        base = b.build_partitioned(toks[:48], segs[:48], 2, batch_size=16)
        live = LiveIndex(base, b.pipeline, batch_size=16)
        before = seg_interact_kernel.launches
        live.insert(toks[48:], segs[48:])
        launched[name] = seg_interact_kernel.launches - before
        assert live.delete(dead) == len(dead)
        lives[name] = live
    assert launched == {"cpu": 0, "cuda": 3}
    cpu, gpu = lives["cpu"], lives["cuda"]
    q = torch.tensor([int(toks[60][toks[60] >= 0][0]), 5, -1, 40, 1000, 7],
                     dtype=torch.int32)
    docs = torch.arange(-1, n + 2, dtype=torch.int32)
    before = csr_lookup_kernel.launches
    m_gpu = gpu.qd_matrix(q.cuda(), docs.cuda()).cpu()
    assert csr_lookup_kernel.launches == before + 2    # base and delta
    torch.testing.assert_close(m_gpu, cpu.qd_matrix(q, docs), **SEG_TOL)
    assert (m_gpu[torch.tensor(dead) + 1] == 0).all()
    params = get_retriever("knrm").init(torch.Generator().manual_seed(0),
                                        cpu.n_b, cpu.functions, device="cpu")
    e_gpu = SeineEngine(gpu, "knrm", copy.deepcopy(params))
    e_cpu = SeineEngine(cpu, "knrm", params)
    s_gpu, i_gpu = e_gpu.retrieve(q, n)
    s_cpu, _ = e_cpu.retrieve(q, n)
    assert not set(dead) & set(i_gpu.cpu().tolist())
    torch.testing.assert_close(s_gpu.cpu(), s_cpu, **SEG_TOL)
    m_before = gpu.qd_matrix(q.cuda(), docs.cuda())
    for live in (cpu, gpu):
        live.compact()
        assert live.generation == 1 and live.delta_nnz == 0
    assert torch.equal(gpu.qd_matrix(q.cuda(), docs.cuda()), m_before)
    for f in ("term_offsets", "doc_ids", "term_to_shard", "range_lo",
              "range_hi", "doc_len", "seg_len"):
        assert torch.equal(getattr(gpu.base, f).cpu(),
                           getattr(cpu.base, f)), f
    torch.testing.assert_close(gpu.base.values.cpu(), cpu.base.values,
                               **SEG_TOL)


def test_knrm_pool_kernel_refuses_a_gradient_on_the_card():
    """The kernel has no backward: inputs that need a gradient raise
    under grad mode, and run under no_grad or without requires_grad."""
    _require_cuda()
    cos = torch.rand((4, 6, 20), device="cuda") * 2 - 1
    mask = torch.ones((4, 20), device="cuda")
    want = knrm_pool_kernel(cos, mask)
    for c, m in ((cos.clone().requires_grad_(True), mask),
                 (cos, mask.clone().requires_grad_(True))):
        with pytest.raises(NotImplementedError, match="no backward"):
            knrm_pool_kernel(c, m)
        with torch.no_grad():
            assert torch.equal(knrm_pool_kernel(c, m), want)


@pytest.mark.parametrize("retriever", ["knrm", "deeptilebars", "hint"])
def test_training_step_on_cuda_matches_cpu(retriever):
    """One training step on the card (the lookup kernel; KNRM through
    knrm_pool, HiNT through ``models.layers.softmax``) against the same
    step on the CPU, over one index built on
    the CPU and carried to the card, from the same initial parameters and
    PairSampler batch: M bitwise, the loss, grad norm and gradients at
    rtol 1e-5 / atol 1e-6, and the step's launches (two scores per
    pair)."""
    _require_cuda()
    from repro_torch.convert import index_to_device
    from repro_torch.data.batching import PairSampler, pad_queries
    from repro_torch.launch.train import pair_batches, ranker_loss_fn
    from repro_torch.train import adam, global_norm, make_train_step
    from repro_torch.train import value_and_grad
    from repro_torch.dist.compression import init_error_feedback
    cfg = seine_smoke()
    ds = generate(cfg, seed=0)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens)
    toks, segs = segment_corpus([vocab.map_tokens(d) for d in ds.docs],
                                cfg.n_segments, max_len=160)
    queries = pad_queries(ds.queries, vocab.map_tokens, q_len=6)
    provider = HashProvider(vocab.size, cfg.embed_dim, device="cpu")
    cpu = IndexBuilder(cfg, vocab, provider, device="cpu").build(
        toks, segs, batch_size=16)
    indexes = {"cpu": cpu, "cuda": index_to_device(cpu, "cuda")}
    init = get_retriever(retriever).init(torch.Generator().manual_seed(0),
                                         cfg.n_segments, cpu.functions,
                                         device="cpu")
    out = {}
    for dev, index in indexes.items():
        sampler = PairSampler(ds.qrels, np.arange(len(queries)),
                              batch_size=16)
        batch = pair_batches(sampler, queries, dev)(0)
        q, d = batch["q"][0], batch["pos"][:1]
        out[dev] = [index.qd_matrix(q, d).cpu()]
        params = copy.deepcopy(init).to(dev)
        before = knrm_pool_kernel.launches, csr_lookup_kernel.launches
        loss, grads = value_and_grad(ranker_loss_fn(retriever, index),
                                     params, batch)
        if dev == "cuda":
            assert csr_lookup_kernel.launches - before[1] == 32
            assert knrm_pool_kernel.launches - before[0] == (
                32 if retriever == "knrm" else 0)
        opt = adam(3e-3)
        _, _, _, m = make_train_step(ranker_loss_fn(retriever, index), opt)(
            params, opt.init(params), init_error_feedback(params), batch)
        out[dev] += [loss.cpu(), global_norm(grads).cpu(), m["loss"].cpu(),
                     {n: g.cpu() for n, g in flatten_with_paths(grads)}]
    (m_c, l_c, n_c, s_c, g_c), (m_g, l_g, n_g, s_g, g_g) = (out["cpu"],
                                                           out["cuda"])
    assert torch.equal(m_g, m_c)
    for got, want in ((l_g, l_c), (n_g, n_c), (s_g, s_c)):
        torch.testing.assert_close(got, want, **TOL)
    assert list(g_g) == list(g_c)
    for n in g_c:
        torch.testing.assert_close(g_g[n], g_c[n], **TOL, msg=n)


def test_flash_attn_at_bert4rec_shape_matches_plain():
    """BERT4Rec's training attention (256, 200, 2 / 2, 32), float32 and
    non-causal: 200 keys are six 32-key tiles and a tail of 8, and the
    KV head's group is 1.  The forward (with and without its lse) and the
    backward kernel against their plain versions on the card at rtol
    1e-4 / atol 1e-5; two backward launches bitwise."""
    _require_cuda()
    g = torch.Generator().manual_seed(13)
    q, k, v, do = (torch.randn(256, 200, 2, 32, generator=g).cuda()
                   for _ in range(4))
    o, lse = flash_attn_kernel(q, k, v, causal=False, return_lse=True)
    assert torch.equal(o, flash_attn_kernel(q, k, v, causal=False))
    want_o, want_lse = flash_attn_plain(q, k, v, causal=False,
                                        return_lse=True)
    torch.testing.assert_close(o, want_o, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-5)
    got = flash_attn_bwd_kernel(q, k, v, o, do, lse, causal=False)
    again = flash_attn_bwd_kernel(q, k, v, o, do, lse, causal=False)
    want = flash_attn_bwd_plain(q, k, v, o, do, lse, causal=False)
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, a2), name
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5, msg=name)


@pytest.mark.parametrize("arch", ["autoint", "dlrm-mlperf", "sasrec",
                                  "bert4rec", "mace"])
def test_recsys_and_mace_training_steps_on_cuda_match_cpu(arch):
    """Three steps of ``fit_recsys`` (``fit_gnn`` for MACE) at the smoke
    config on the card against the same steps on the CPU from the same
    weights: loss and gradient norm per step at rtol 1e-4 / atol 1e-5;
    BERT4Rec launches both flash_attn kernels once per block and step,
    the others none; the card's run is bitwise the same twice."""
    _require_cuda()
    from repro_torch.launch import train as train_cli
    from repro_torch.models import mace as MA
    cfg = smoke(arch)
    if arch == "mace":
        init = MA.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        fit = lambda p: train_cli.fit_gnn(cfg, p, 3, None, verbose=False)
    else:
        init = train_cli.recsys_init(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
        fit = lambda p: train_cli.fit_recsys(cfg, p, 3, None, verbose=False)
    on = lambda dev: tree_map(lambda t: t.to(dev), init)
    before = (flash_attn_kernel.launches, flash_attn_bwd_kernel.launches)
    runs = [fit(on("cuda")), fit(on("cuda")), fit(on("cpu"))]
    n = 3 * 2 * cfg.n_blocks if arch == "bert4rec" else 0
    assert (flash_attn_kernel.launches - before[0],
            flash_attn_bwd_kernel.launches - before[1]) == (n, n)
    for key in ("loss", "grad_norm"):
        assert [h[key] for h in runs[0].history] == \
            [h[key] for h in runs[1].history], key
        np.testing.assert_allclose([h[key] for h in runs[0].history],
                                   [h[key] for h in runs[2].history],
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def _smoke_lm_bundles(monkeypatch):
    """``launch.steps.build_cell`` over a bf16 smoke stablelm whose
    train_4k is (4, 64) in 2 microbatches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as S
    real = S.get_bundle
    shape = ShapeConfig(name="train_4k", kind="training", seq_len=64,
                        global_batch=4)

    def bundle(arch):
        b = real(arch)
        return dataclasses.replace(b, config=dataclasses.replace(
            smoke(arch), dtype="bfloat16"), shapes=(shape,))
    monkeypatch.setattr(S, "get_bundle", bundle)
    monkeypatch.setattr(S, "MICROBATCH_TOKENS", 128)


def test_run_cell_trains_a_lm_cell_through_both_attention_kernels(
        monkeypatch):
    """``launch.dryrun.run_cell`` of a smoke bf16 LM training cell on the
    card: counted, stepped (2 microbatches, remat), the forward and the
    backward attention kernels launched by the step."""
    _require_cuda()
    from repro_torch.launch import dryrun
    _smoke_lm_bundles(monkeypatch)
    before = (flash_attn_kernel.launches, flash_attn_bwd_kernel.launches)
    rec = dryrun.run_cell("stablelm-1.6b", "train_4k", device="cuda",
                          repeats=1, verbose=False)
    assert rec["on_card"] and rec["step_s"] > 0
    assert rec["memory"]["peak_gib_per_device"] > 0
    n_l = smoke("stablelm-1.6b").n_layers
    # per microbatch and layer: forward and recompute, then one backward
    assert flash_attn_kernel.launches - before[0] == 2 * 2 * n_l
    assert flash_attn_bwd_kernel.launches - before[1] == 2 * n_l


def test_run_cell_builds_through_seg_interact_and_embed_bag(monkeypatch):
    """``run_cell`` of SEINE's ``index_build`` cell at 64 docs on the
    card: one ``seg_interact`` launch, and ``embed_bag``'s segment entry
    twice (the contextual mix, ``log_cond_prob``) a step."""
    _require_cuda()
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as S
    monkeypatch.setattr(S, "SEINE_BUILD_DOCS", 64)
    before = (seg_interact_kernel.launches, embed_bag_kernel.launches)
    rec = dryrun.run_cell("seine", "index_build", device="cuda", repeats=2,
                          verbose=False)
    assert rec["on_card"] and rec["meta"]["docs_per_step"] == 64
    assert (seg_interact_kernel.launches - before[0],
            embed_bag_kernel.launches - before[1]) == (2, 4)
