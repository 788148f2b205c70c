"""The port's CUDA kernels on the card, each held against its plain
PyTorch version on the same inputs (bitwise for the lookups and the
scans, raw and packed, rtol 1e-5 / atol 1e-6 for the KNRM bank, rtol
1e-4 / atol 1e-5 for seg_interact and float32 flash_attn, whose plain
versions sum in another order, 2e-2 for bf16 flash_attn), the engine on
CUDA, raw and packed, against the engine on the CPU, and the offline
build on the card against the same build on the CPU, with a HashProvider
and with an LMProvider.

embed_bag, the provider's segment sums and the serving front end on the
card are held bitwise against the plain versions and ``engine.score``.

This file imports neither jax nor repro, so it runs on a GPU host that
has only PyTorch: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py``.  Without a CUDA device every test skips.
"""
import copy
import dataclasses
import os

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
                                           embed_bag_kernel, embed_bag_plain)
from repro_torch.kernels.csr_lookup import (csr_lookup_kernel,
                                            csr_lookup_packed_kernel,
                                            lane_scales, retrieve_lanes,
                                            retrieve_windows_kernel,
                                            retrieve_windows_packed_kernel)
from repro_torch.kernels.flash_attn import (flash_attention,
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
from torch_codec_rows import adversarial_index, adversarial_queries

pytestmark = pytest.mark.gpu

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_hot_term_k4")
TOL = dict(rtol=1e-5, atol=1e-6)


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
    want = seg_interact_plain(e_term, e_tok, seg, term_ids, n_seg)
    torch.testing.assert_close(got.cpu(), want, **SEG_TOL)
    assert torch.equal(got, again)
    assert (got[term_ids.cuda() < 0] == 0).all()
    if n_seg > 1:
        assert (got[:, :, 1] == 0).all()


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
        want = flash_attn_plain(q, k, v, causal=causal)
        torch.testing.assert_close(got.cpu().float(), want.float(), **tol)


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


def _lm_build(device, n_docs=24):
    cfg = dataclasses.replace(seine_smoke(), n_docs=n_docs)
    ds = generate(cfg, seed=0)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens,
                             keep_frac=cfg.vocab_keep_frac)
    toks, segs = segment_corpus([vocab.map_tokens(d) for d in ds.docs],
                                cfg.n_segments, max_len=160)
    lm = smoke("minitron-4b")
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
