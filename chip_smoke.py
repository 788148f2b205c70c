#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SEINE (query phase, offline build,
front end, LM bridge) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failed check raises, and the script exits non-zero):

0. Build every kernel of the path from the sources in the checkout (one
   ``nvcc`` per source, started together) and print the card's name and
   power limit as ``nvidia-smi`` reports them.
1. The full-width index: SEINE on LETOR MQ2007 (``configs/seine_letor.py``)
   at its full 65,323 docs, n_b = 20 segments and the nine atomic
   functions, over a Zipfian vocabulary of 100k terms with a hot head of
   4 terms that post in every doc and ~150 distinct terms per doc (~9.8M
   postings, ~7 GB of float32 values).  Postings are drawn on the host
   with numpy from ``--seed``, values on the card from a
   ``torch.Generator``; the port's ``build_from_rows`` assembles it.  The
   port's ``partition_index`` then splits it into K = 4 term-range shards
   (planned and merged on the host) and ``pack_index`` packs that under
   codecs ``packed`` and ``packed-q8`` at tile 256; each codec's posting
   bytes and the host seconds are printed.
2. Each kernel against its plain PyTorch version on the card, at the
   serving shapes and on adversarial ids: ``csr_lookup`` at tiles
   {64, 256, 1024} (bitwise), ``retrieve_windows`` over every doc block of
   a query (bitwise), ``knrm_pool`` (rtol 1e-5 / atol 1e-6), and the
   committed K=4 hot-term-split fixture (``tests/data/torch_hot_term_k4``:
   per-pair routing, K > 1; bitwise).  Then, for both codecs, the same
   for ``csr_lookup_packed`` (tiles {64, 256, 1024}) and
   ``retrieve_windows_packed`` (every doc block of a query), and both over
   the fixture packed on the card; all bitwise, ``packed`` also against
   the raw index's M.
3. Serving, one path per codec: a ``SeineEngine`` with KNRM over the raw
   phase-1 index, then over its ``packed`` and its ``packed-q8``
   partition, each answers 16 requests of 6 query slots x 1,000
   candidates through ``serve_batches`` and 8 top-1000 queries through
   ``serve_retrieval``.  The launch counts are zeroed just before each
   path and read just after it, and every kernel of that path must have
   risen.  Raw scores are checked against the plain path (ref lookup,
   plain kernel bank, on the CPU) and retrieval against brute force;
   ``packed`` scores and top-k ids must equal the raw path's, and
   ``packed-q8`` M must stay within max(scale) / 2 of the exact M with the
   same sparsity, with recall@10 >= 0.9 against the raw path.
4. Timing: each kernel, its plain version and, where one PyTorch call
   computes the same function, that call, with CUDA events; the bound is
   the larger of bytes / 3.35 TB/s and operations / 67 TFLOP/s (H100 SXM
   data-sheet peaks) for this run's data.  The packed kernels are timed
   under both codecs (``packed`` in the row's own keys, ``packed-q8``
   under ``q8``).

5. The offline build at full width and scale: SEINE_LETOR
   (``configs/seine_letor.py``) at its full 65,323 docs, n_b = 20,
   De = 128 and the nine atomic functions; corpus, middle-80% vocabulary
   and TextTiling (``max_len`` 512) on the host, a ``HashProvider`` table
   and interaction parameters from ``torch.Generator``s seeded by
   ``--seed``.  ``IndexBuilder.build_partitioned`` (K = 4, batches of 32
   docs, up to 512 unique terms each) streams every batch through the
   card once, with the launch counts zeroed just before and read just
   after (``seg_interact`` once per batch).  Then ``seg_interact``
   against its plain version (a full build batch, bitwise run to run;
   the JAX-signature sweep of tests/test_kernels.py with an empty
   segment), the card's build of the first 64 docs against the same
   build on the CPU (ids bitwise, values at rtol 1e-4 / atol 1e-5),
   indexed M against No-Index M for the stored pairs of 8 docs (atol
   1e-5), the built index served by a KNRM ``SeineEngine`` (16 requests
   of 6 slots x 1,000 candidates) and a ``NoIndexEngine`` (4 of them;
   scores at rtol 1e-4 / atol 1e-5, p50/p95 of both), a ``save_index`` /
   ``load_index`` round trip, and ``seg_interact``'s timing against its
   plain version and its bound.  ``embed_bag`` (the provider's and
   ``log_cond_prob``'s segment sums) must launch twice per batch; it is
   held against its plain version on the build's own calls (captured by
   running 16 batches again) and over tests/test_kernels.py's sweep with
   empty bags, -1 and past-table ids in float32 and bf16 (rtol 1e-5 /
   atol 1e-6; bitwise is printed), and timed at both build shapes
   beside ``F.embedding_bag`` and its bound.

7. The serving front end over phase 5's K = 4 index with KNRM: the
   closed-loop rate R of 64 LETOR requests (6 slots x 1,000 candidates)
   through ``serve_batches``, then 256 such requests through
   ``run_open_loop`` at R and at R / 2 (``max_batch`` 8,
   ``batch_timeout_ms`` 2, ``slo_ms`` 50) naive, coalesced, and
   coalesced with a 4,096-tile cache; every served score must equal
   ``engine.score`` bitwise.  Per run: p50 / p95, queue ms, goodput,
   batches, the dedupe ratio and the cache counters from ``obs``,
   launches per kernel, and the busy share.  Then one ``swap_engine``
   to a ``packed`` copy of the partition: the scores after it must equal
   the packed engine's and the cache's epoch must rise.  (Phase 7 runs
   before phase 6, while phase 5's index is still on the card.)

Every busy share is printed with how many of the port's kernel
launches CUPTI recorded over the replay ("k of n").

6. The LM bridge: the same corpus embedded by minitron-4b
   (``configs/lm_archs.py``: 32 layers, d_model 3,072, 24 query heads
   over 8 KV heads, head_dim 128, d_ff 9,216, vocab 256,000, bf16) at its
   full published width and depth, with random weights drawn on the card
   from ``--seed`` at the reference init's scales, through
   ``LMProvider(embed_dim=128)``.  The ``flash_attn`` kernel against its
   plain version at the build's shape (32 docs x 512 positions, causal;
   bf16 at 2e-2, float32 at rtol 1e-4 / atol 1e-5) and over the shapes of
   tests/test_kernels.py::TestFlashAttention, a non-causal one and S =
   160 with a group of 3; one build batch's ``contextualize`` through the
   kernel against the plain attention (2e-2, with the weights cast to
   float32; the bf16 difference is printed).  Then
   ``build_partitioned(K=4)`` over the first 1,024 docs (32 batches of
   32), counts zeroed just before and read just after: ``flash_attn``
   must launch n_layers x batches times and ``seg_interact`` once per
   batch.  The device time of a build batch is split into GEMMs,
   ``flash_attn``, ``seg_interact`` and the rest (CUPTI).  Indexed M
   equals No-Index M (``make_qd_fn`` over the first batch's docs in build
   order) for every stored pair at atol 1e-5; a KNRM ``SeineEngine``
   serves 8 requests of 6 slots x 256 built docs and a ``NoIndexEngine``
   over the same LM answers 2 of them over 32 candidates (scores at the
   bf16 bar, 2e-2).  Last ``flash_attn``'s timing at the build's shape
   against its plain version, ``F.scaled_dot_product_attention`` and its
   bound (bytes over 3.35 TB/s or causal flops over the bf16 989
   TFLOP/s), and the phase's peak device memory.

The second-to-last line of output is one JSON object with a ``kernels``
list; the last is ``{"ok": true, "device": {...}}``.  Nothing of JAX or
of the ``repro`` package is imported.
"""
import argparse
import copy
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.ckpt import load_index, save_index  # noqa: E402
from repro_torch.configs import SEINE_LETOR, get_lm_config  # noqa: E402
from repro_torch.core.build_pipeline import (  # noqa: E402
    make_unique_terms_fn)
from repro_torch.core.builder import IndexBuilder  # noqa: E402
from repro_torch.core.index import build_from_rows  # noqa: E402
from repro_torch.core.interactions import (  # noqa: E402
    init_interaction_params, seg_interact_inputs)
from repro_torch.core.providers import (HashProvider,  # noqa: E402
                                        LMProvider)
from repro_torch.core.segment import segment_corpus  # noqa: E402
from repro_torch.core.vocab import build_vocabulary  # noqa: E402
from repro_torch.data.batching import (candidates_for_query,  # noqa: E402
                                       pad_queries)
from repro_torch.data.synth_corpus import generate  # noqa: E402
from repro_torch.data.synth_corpus import ZIPF_FUNCTIONS  # noqa: E402
from repro_torch.kernels import build_all  # noqa: E402
from repro_torch.dist.partition import pack_index  # noqa: E402
from repro_torch.dist.sharding import partition_index  # noqa: E402
from repro_torch.kernels.csr_lookup import (  # noqa: E402
    csr_lookup_kernel, csr_lookup_packed_kernel, csr_lookup_packed_plain,
    csr_lookup_plain, lane_scales, retrieve_lanes, retrieve_windows_kernel,
    retrieve_windows_packed_kernel, route_pairs, route_terms,
    scan_block_packed_ref, scan_block_ref)
from repro_torch.kernels.csr_lookup.ops import _route_cells  # noqa: E402
from repro_torch.kernels.embed_bag import (  # noqa: E402
    bag_ptr_from_offsets, embed_bag_kernel, embed_bag_plain)
from repro_torch.kernels.embed_bag import ops as embed_bag_ops  # noqa: E402
from repro_torch.kernels.csr_lookup.ref import _lane_scale  # noqa: E402
from repro_torch.kernels.flash_attn import (flash_attn_kernel,  # noqa: E402
                                            flash_attn_plain)
from repro_torch.kernels.knrm_pool import (knrm_pool_kernel,  # noqa: E402
                                           knrm_pool_ref)
from repro_torch.kernels.seg_interact import (  # noqa: E402
    flatten_segments, seg_interact, seg_interact_kernel, seg_interact_plain)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.retrievers import get_retriever  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DeadlineExceeded, NoIndexEngine, SeineEngine, ServingFrontend,
    make_qmeta, run_open_loop, serve_batches, serve_retrieval)

N_DOCS = 65_323          # MQ2007, configs/seine_letor.py
N_B = 20                 # configs/base.py n_segments (Fig. 2 best)
VOCAB = 100_000
N_HOT = 4
TAIL_DRAWS = 164         # Zipf(s=1) draws per doc -> ~146 distinct + 4 hot
Q_SLOTS = 6              # launch/serve.py pad_queries(q_len=6)
N_CAND = 1000
N_REQUESTS = 16
N_RETRIEVE = 8
TOP_K = 1000
K_SHARDS = 4             # term-range shards of the packed indexes
PACK_TILE = 256          # codec tile (the build-time POSTING_TILE)
CODECS = ("packed", "packed-q8")
HBM_BYTES_PER_S = 3.35e12    # H100 SXM
FP32_FLOPS_PER_S = 67e12     # H100 SXM, outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/{}/csrc/{}.cu"
TPU_KERNELS = {
    "csr_lookup": "src/repro/kernels/csr_lookup/kernel.py:217",
    "retrieve_windows": "src/repro/kernels/csr_lookup/kernel.py:162",
    "knrm_pool": "src/repro/kernels/knrm_pool/kernel.py:34",
    "csr_lookup_packed": "src/repro/kernels/csr_lookup/kernel.py:359",
    "retrieve_windows_packed": "src/repro/kernels/csr_lookup/kernel.py:442",
    "seg_interact": "src/repro/kernels/seg_interact/kernel.py:50",
    "flash_attn": "src/repro/kernels/flash_attn/kernel.py:63",
    "embed_bag": "src/repro/kernels/embed_bag/kernel.py:40",
}
# the launch counter of each kernel, and the kernels each serving path
# (codec) must launch
COUNTERS = {"csr_lookup": csr_lookup_kernel,
            "retrieve_windows": retrieve_windows_kernel,
            "knrm_pool": knrm_pool_kernel,
            "csr_lookup_packed": csr_lookup_packed_kernel,
            "retrieve_windows_packed": retrieve_windows_packed_kernel,
            "seg_interact": seg_interact_kernel,
            "flash_attn": flash_attn_kernel,
            "embed_bag": embed_bag_kernel}
# a piece of each kernel's CUDA function name, as CUPTI records it
KERNEL_NAMES = {"csr_lookup": "csr_lookup_kernel",
                "retrieve_windows": "retrieve_block_kernel",
                "knrm_pool": "knrm_pool_kernel",
                "csr_lookup_packed": "csr_lookup_packed_kernel",
                "retrieve_windows_packed": "retrieve_block_packed_kernel",
                "seg_interact": "seg_interact_kernel",
                "flash_attn": "flash_attn_kernel",
                "embed_bag": "embed_bag_"}
PATH_KERNELS = {"none": ("csr_lookup", "retrieve_windows", "knrm_pool"),
                "packed": ("csr_lookup_packed", "retrieve_windows_packed",
                           "knrm_pool"),
                "packed-q8": ("csr_lookup_packed", "retrieve_windows_packed",
                              "knrm_pool")}
FIXTURE = os.path.join(REPO, "tests", "data", "torch_hot_term_k4")
# phase 5, the offline build: SEINE_LETOR at the full MQ2007 size
BUILD_DOCS = 65_323
BUILD_N_B = 20           # configs/seine_letor.py
BUILD_DE = 128           # configs/seine_letor.py embed_dim
BUILD_MAX_LEN = 512      # segment_corpus max_len
BUILD_MAX_UNIQ = 512
BUILD_BATCH = 32
BUILD_K = 4              # build_partitioned shards
BUILD_CHECK_DOCS = 64    # the card's build against the plain CPU build
BUILD_PAIR_DOCS = 8      # indexed == on-the-fly
NOINDEX_REQUESTS = 4
SEG_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_kernels.py's bar
# its kernel-vs-index bar, for the sweep at the reference's unit scale
SEG_UNIT_TOL = dict(rtol=1e-3, atol=1e-4)
# the JAX-signature shapes of tests/test_kernels.py::TestSegInteract
SEG_SWEEP = ((64, 4, 128, 32), (300, 7, 256, 128), (256, 3, 128, 64),
             (128, 2, 128, 200))
INDEX_DIR = os.path.join(REPO, "build", "chip_smoke_index")
EB_TOL = dict(rtol=1e-5, atol=1e-6)    # tests/test_kernels.py's bar
# (V, D, B, maxbag): tests/test_kernels.py::TestEmbedBag's sweep
EB_SWEEP = ((100, 32, 8, 10), (50, 16, 4, 6), (200, 128, 16, 20),
            (30, 8, 5, 3))
# phase 7, the serving front end over phase 5's index
FE_CLOSED = 64           # closed-loop requests that set the offered rate
FE_REQUESTS = 256
FE_MAX_BATCH = 8
FE_TIMEOUT_MS = 2.0
FE_SLO_MS = 50.0
FE_CACHE_TILES = 4096    # 4,096 x 256 postings x 20 x 9 f32 = 755 MB
FE_SWAP_REQUESTS = 8
FE_RATES = (1.0, 0.5)    # offered load as fractions of R
FE_MODES = (("naive", dict(coalesce=False)),
            ("coalesce", dict(coalesce=True)),
            ("coalesce+cache", dict(coalesce=True,
                                    cache_tiles=FE_CACHE_TILES)))
# phase 6, the LM bridge: phase 5's corpus embedded by minitron-4b
LM_ARCH = "minitron-4b"
LM_DOCS = 1024           # of phase 5's 65,323 docs: cut for the run's time
LM_BATCH = 32
LM_K = 4
LM_REQUESTS = 8
LM_CAND = 256
LM_NOINDEX_REQUESTS = 2
LM_NOINDEX_CAND = 32
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FA_F32_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_kernels.py's bar
# (B, S, Hq, Hkv, hd, causal): tests/test_kernels.py::TestFlashAttention's
# causal shapes and its non-causal one, and S = 160 with a group of 3
FA_SWEEP = ((2, 128, 4, 2, 32, True), (1, 256, 8, 8, 64, True),
            (2, 64, 4, 1, 16, True), (1, 96, 2, 2, 32, True),
            (1, 64, 4, 2, 32, False), (2, 160, 6, 2, 32, True))
BF16_FLOPS_PER_S = 989e12    # H100 SXM, dense bf16 tensor cores
GEMM_KERNELS = ("gemm", "xmma", "nvjet", "cutlass", "cublas", "splitk")


def log(*a):
    print(*a, flush=True)


def zipf_p(n: int) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64)
    return p / p.sum()


def build_index(seed: int, dev: torch.device):
    """Phase 1: the MQ2007-scale index described in the module doc."""
    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    # the tail continues the Zipf law of the whole vocabulary past the head
    p_tail = zipf_p(VOCAB)[N_HOT:]
    tail = rng.choice(VOCAB - N_HOT, size=(N_DOCS, TAIL_DRAWS),
                      p=p_tail / p_tail.sum()) + N_HOT
    docs = np.arange(N_DOCS, dtype=np.int64)
    keys = np.unique(np.concatenate([
        (docs[:, None] * VOCAB + np.arange(N_HOT)).ravel(),
        (docs[:, None] * VOCAB + tail).ravel()]))
    doc_ids, term_ids = keys // VOCAB, keys % VOCAB
    df = np.bincount(term_ids, minlength=VOCAB)
    doc_len = rng.randint(100, 1100, size=N_DOCS).astype(np.float32)
    # ~30-token segments: short docs leave trailing segments empty
    used = np.minimum(N_B, np.ceil(doc_len / 30)).astype(np.int64)
    seg_len = np.where(np.arange(N_B)[None, :] < used[:, None],
                       np.floor(doc_len / used)[:, None], 0.0
                       ).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    values = torch.rand((keys.size, N_B, len(ZIPF_FUNCTIONS)),
                        generator=gen, device=dev)
    # cosine is stored as a segment sum of per-token cosines in [-1, 1]
    cos = ZIPF_FUNCTIONS.index("cosine")
    values[..., cos] = (values[..., cos] * 2 - 1) * torch.from_numpy(
        seg_len).to(dev)[torch.from_numpy(doc_ids).to(dev)] * 0.5
    index = build_from_rows(
        doc_ids.astype(np.int32), term_ids.astype(np.int32), values,
        idf=np.log(N_DOCS / np.maximum(df, 1)).astype(np.float32),
        doc_len=doc_len, seg_len=seg_len, n_docs=N_DOCS, vocab_size=VOCAB,
        functions=ZIPF_FUNCTIONS, device=dev)
    del values
    torch.cuda.synchronize()
    log(f"phase 1: index nnz={index.nnz} bytes={index.nbytes} "
        f"terms/doc={index.nnz / N_DOCS:.1f} "
        f"empty terms={int((df == 0).sum())} "
        f"built in {time.perf_counter() - t0:.1f}s")
    return index, rng


def build_packed(index):
    """Phase 1, continued: the index split into K_SHARDS term-range shards
    by the port's ``partition_index`` (planned and merged on the host, as
    in the reference), then packed under each codec at PACK_TILE."""
    t0 = time.perf_counter()
    pidx = partition_index(index, K_SHARDS)
    torch.cuda.synchronize()
    secs = {"partition": time.perf_counter() - t0}
    out = {"none": pidx}
    for codec in CODECS:
        t0 = time.perf_counter()
        out[codec] = pack_index(pidx, codec, tile=PACK_TILE)
        torch.cuda.synchronize()
        secs[codec] = time.perf_counter() - t0
    bits = out["packed"].tile_bits
    words = out["packed"].packed_words
    log(f"phase 1: partition_index K={pidx.n_shards} nmax={pidx.nmax} "
        f"split_term={pidx.split_term is not None} in "
        f"{secs['partition']:.2f}s (host plan + merge, values to and from "
        f"the card)")
    for codec in ("none",) + CODECS:
        log(f"phase 1: codec {codec}: posting_nbytes="
            f"{out[codec].posting_nbytes}"
            + (f" packed in {secs[codec]:.2f}s" if codec in secs else ""))
    hist = {c: int((bits == c).sum()) for c in (0, 4, 8, 16, 32)}
    log(f"phase 1: tiles per width class {hist}, packed words with the "
        f"top bit set: {int((words < 0).sum())}")
    return out, secs


def draw_query(rng, n_real: int) -> np.ndarray:
    q = np.full(Q_SLOTS, -1, np.int32)
    q[:n_real] = rng.choice(VOCAB, size=n_real, replace=False,
                            p=zipf_p(VOCAB))
    return q


def assert_equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if not torch.equal(got, want):
        diff = (got - want).abs().max().item()
        raise AssertionError(f"{what}: kernel != plain (max |diff| {diff})")


def check_lookup(index, q, docs, tiles, what):
    """csr_lookup kernel == its plain version (the kernel's dataflow run
    by ``csr_lookup_plain``) and == the ref lowering, bit for bit."""
    ref = index.qd_matrix(q, docs, impl="ref")
    for tile in tiles:
        got = index.qd_matrix(q, docs, tile=tile)
        want = plain_lookup(index, q, docs, tile)
        torch.cuda.synchronize()
        assert_equal(got, want, f"{what} csr_lookup tile={tile}")
        assert_equal(got, ref, f"{what} csr_lookup vs ref tile={tile}")


def plain_lookup(index, q, docs, tile):
    """``csr_lookup_plain`` on the card, fed the same routing and fences
    the kernel wrapper is fed."""
    from repro_torch.core.index import build_fences
    to, dids, vals, t2s, rlo, _ = stacked(index)
    split = getattr(index, "split_term", None)
    if split is None:
        k, lo, hi = route_terms(q, to, t2s, rlo)
    else:
        shape = (q.shape[0], docs.shape[0])
        k, lo, hi = route_pairs(q[:, None].expand(shape),
                                docs[None].expand(shape), to, t2s, rlo,
                                split, index.split_doc)
    return csr_lookup_plain(k, lo, hi, docs, dids, build_fences(dids, tile),
                            vals, tile=tile)


def lookup_inputs(index, q, docs):
    """The csr_lookup wrapper's arguments at one request (K == 1, the
    build-time tile 256)."""
    k, lo, hi = route_terms(q, index.term_offsets[None], None, None)
    return (k.contiguous(), lo.contiguous(), hi.contiguous(), docs,
            index.doc_ids[None], index.fences[None], index.values[None])


def stacked(index):
    """(term_offsets, doc_ids, values, t2s, range_lo, range_hi)."""
    if hasattr(index, "term_to_shard"):
        return (index.term_offsets, index.doc_ids, index.values,
                index.term_to_shard, index.range_lo, index.range_hi)
    return (index.term_offsets[None], index.doc_ids[None],
            index.values[None], None, None, None)


def check_scan(index, q, block, what):
    """retrieve_windows kernel == its plain version over every block."""
    to, dids, vals, t2s, rlo, rhi = stacked(index)
    lo, hi = retrieve_lanes(q, to, t2s, rlo, rhi, dids.shape[1])
    lo, hi = lo.contiguous(), hi.contiguous()
    err = 0.0
    for blo in range(0, index.n_docs, block):
        got = retrieve_windows_kernel(dids, vals, lo, hi, blo, block,
                                      tile=256)
        want = scan_block_ref(dids, vals, lo, hi, blo, block)
        assert_equal(got, want, f"{what} retrieve_windows blo={blo}")
        err = max(err, (got - want).abs().max().item())
    return err


def phase2(index, rng, dev):
    """Each kernel against its plain version on the card."""
    # csr_lookup on adversarial ids: present terms, the hot head, OOV
    # padding, an empty term, past-vocab; first/last/random docs, one and
    # many past the end, negative, and a padded tail
    counts = (index.term_offsets[1:] - index.term_offsets[:-1]).cpu().numpy()
    empty = np.flatnonzero(counts == 0)
    d0 = int(rng.randint(N_DOCS))
    term_of = np.repeat(np.arange(VOCAB), counts)
    d0_terms = term_of[index.doc_ids.cpu().numpy() == d0]
    q = np.array([0, d0_terms[-1], -1, empty[0] if empty.size else 7,
                  VOCAB + 5, N_HOT], np.int32)
    # N_CAND candidates in all, the main path's shape
    docs = np.r_[[0, N_DOCS - 1, d0, N_DOCS, N_DOCS + 50, -3],
                 rng.randint(0, N_DOCS, size=N_CAND - 11),
                 [0] * 5].astype(np.int32)
    qt, dt = torch.from_numpy(q).to(dev), torch.from_numpy(docs).to(dev)
    check_lookup(index, qt, dt, (64, 256, 1024), "full index")
    log(f"phase 2: csr_lookup == plain (bitwise) at {Q_SLOTS} x {N_CAND}, "
        f"tiles 64/256/1024")

    # retrieve_windows over every doc block of one query (hot term in it)
    scan_err = check_scan(index, qt, 1024, "full index")
    log("phase 2: retrieve_windows == plain (bitwise) over all blocks")

    # knrm_pool at the serving shape, plus exact-match and empty segments
    g = torch.Generator(device=dev).manual_seed(1)
    cos = torch.rand((N_CAND, Q_SLOTS, N_B), generator=g, device=dev) * 2 - 1
    cos[0, 0] = 1.0
    cos[1, 0] = -1.0
    mask = (torch.rand((N_CAND, N_B), generator=g, device=dev) > 0.2).float()
    mask[2] = 0.0
    got = knrm_pool_kernel(cos, mask)
    want = knrm_pool_ref(cos, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    knrm_err = (got - want).abs().max().item()
    log(f"phase 2: knrm_pool == plain at rtol 1e-5/atol 1e-6 "
        f"(max |diff| {knrm_err:.3g})")

    # the K=4 hot-term-split fixture: per-pair routing, K > 1
    fx = load_index(FIXTURE, device=dev)
    assert fx.split_term is not None and fx.n_shards == 4
    qf = torch.tensor([0, 1, 17, -1, fx.vocab_size + 3, 39, 3],
                      dtype=torch.int32, device=dev)
    df = torch.arange(-1, fx.n_docs + 2, dtype=torch.int32, device=dev)
    check_lookup(fx, qf, df, (4, 64, 256, 1024), "K=4 fixture")
    for block in (16, 64):
        check_scan(fx, qf, block, "K=4 fixture")
    log("phase 2: K=4 sub-sharded fixture == plain (bitwise)")
    return dict(scan_err=scan_err, knrm_err=knrm_err, q=qt, docs=dt,
                fixture=fx, fixture_q=qf, fixture_docs=df)


def packed_args(pidx, q, docs):
    """The packed lookup wrapper's arguments at one request, routed and
    scaled as ``ops.csr_lookup`` routes and scales them."""
    k, lo, hi, w = _route_cells(q, docs, pidx.term_offsets,
                                pidx.term_to_shard, pidx.range_lo,
                                pidx.split_term, pidx.split_doc)
    scale = (None if pidx.value_scale is None else
             _lane_scale(pidx.value_scale, pidx.range_lo, k, w).contiguous())
    i32 = lambda a: a.to(torch.int32).contiguous()
    return (i32(k), i32(lo), i32(hi), docs, pidx._packed(), pidx.fences,
            pidx._serve_values, scale)


def check_packed_lookup(pidx, q, docs, what, raw=None):
    """csr_lookup_packed kernel (through the index's lookup, the main
    path's call) == its plain version == the ref lowering, bit for bit;
    and == the raw index's M when ``raw`` is given."""
    got = pidx.qd_matrix(q, docs)
    want = csr_lookup_packed_plain(*packed_args(pidx, q, docs),
                                   tile=pidx.codec_tile)
    torch.cuda.synchronize()
    assert_equal(got, want, f"{what} csr_lookup_packed")
    assert_equal(got, pidx.qd_matrix(q, docs, impl="ref"),
                 f"{what} csr_lookup_packed vs ref")
    if raw is not None:
        assert_equal(got, raw.qd_matrix(q, docs),
                     f"{what} csr_lookup_packed vs the raw index")
    return got


def packed_lanes(pidx, q):
    """(lane_lo, lane_hi, lane_scale) of one query over a packed index."""
    lo, hi = retrieve_lanes(q, pidx.term_offsets, pidx.term_to_shard,
                            pidx.range_lo, pidx.range_hi, pidx.nmax)
    scale = (None if pidx.value_scale is None else
             lane_scales(pidx.value_scale, pidx.range_lo, q).contiguous())
    return (lo.to(torch.int32).contiguous(),
            hi.to(torch.int32).contiguous(), scale)


def check_packed_scan(pidx, q, block, what, raw=None):
    """retrieve_windows_packed kernel == its plain version over every
    block (and == the raw scan when ``raw`` is given)."""
    lo, hi, scale = packed_lanes(pidx, q)
    args = (pidx._packed(), pidx.fences, pidx._serve_values, scale, lo, hi)
    if raw is not None:
        to, dids, vals, t2s, rlo, rhi = stacked(raw)
        r_lo, r_hi = retrieve_lanes(q, to, t2s, rlo, rhi, dids.shape[1])
    for blo in range(0, pidx.n_docs, block):
        got = retrieve_windows_packed_kernel(*args, blo, block,
                                             tile=pidx.codec_tile)
        want = scan_block_packed_ref(*args, blo, block,
                                     tile=pidx.codec_tile)
        assert_equal(got, want, f"{what} retrieve_windows_packed blo={blo}")
        if raw is not None:
            assert_equal(got, retrieve_windows_kernel(
                dids, vals, r_lo.contiguous(), r_hi.contiguous(), blo,
                block, tile=256), f"{what} packed scan vs raw blo={blo}")


def phase2_packed(index, packed, p2):
    """The packed kernels against their plain versions on the card."""
    q, docs = p2["q"], p2["docs"]
    for codec in CODECS:
        raw = index if codec == "packed" else None
        for tile in (64, 256, 1024):
            pidx = (packed[codec] if tile == PACK_TILE
                    else pack_index(packed["none"], codec, tile=tile))
            check_packed_lookup(pidx, q, docs, f"{codec} tile={tile}", raw)
            del pidx
        log(f"phase 2: csr_lookup_packed ({codec}) == plain == ref "
            f"(bitwise) at {Q_SLOTS} x {N_CAND}, tiles 64/256/1024"
            + (", == the raw index's M" if raw is not None else ""))
        check_packed_scan(packed[codec], q, 1024, codec, raw)
        log(f"phase 2: retrieve_windows_packed ({codec}) == plain "
            "(bitwise) over all blocks"
            + (", == the raw scan" if raw is not None else ""))
        fx = pack_index(p2["fixture"], codec, tile=8)
        for tile in (8, 64, 256):
            fxt = fx if tile == 8 else pack_index(p2["fixture"], codec,
                                                  tile=tile)
            check_packed_lookup(fxt, p2["fixture_q"], p2["fixture_docs"],
                                f"K=4 fixture {codec} tile={tile}",
                                p2["fixture"] if codec == "packed" else None)
            for block in (16, 64):
                check_packed_scan(fxt, p2["fixture_q"], block,
                                  f"K=4 fixture {codec} tile={tile}",
                                  p2["fixture"] if codec == "packed"
                                  else None)
        log(f"phase 2: K=4 sub-sharded fixture packed on the card "
            f"({codec}, tiles 8/64/256) == plain (bitwise)")


def reference_scores(engine, q, docs):
    """Scores on the plain path: the ref lookup on the card, then the
    retriever on the CPU (plain kernel bank)."""
    index = engine.index
    with torch.inference_mode():
        m = index.qd_matrix(q, docs, impl="ref")
        meta = make_qmeta(index, q, docs)
    cpu_meta = type(meta)(**{n: getattr(meta, n).cpu()
                             for n in meta.__dataclass_fields__})
    params = copy.deepcopy(engine.params).to("cpu")
    with torch.inference_mode():
        return engine.spec.score(params, m.cpu(), cpu_meta,
                                 index.functions).numpy()


def device_busy(run, n: int):
    """Device time of profiled replays of a serving loop of ``n``
    requests: kernel, memcpy and memset time summed by CUPTI, per
    request; then (profiling the host alone, so no device time is
    counted twice) the host calls that took the most self time.  CUPTI
    was seen to drop kernel records late in this script, so the port's
    kernel records it kept are counted against the launch counters over
    the same replay (``recorded`` of ``launched``); a share over fewer
    records than launches is printed unscaled and flagged."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    for fn in COUNTERS.values():
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launched = sum(fn.launches for fn in COUNTERS.values())
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    recorded = sum(e.count for e in prof.key_averages()
                   if any(k in e.key for k in KERNEL_NAMES.values()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:6]
    summary = ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / n:.3f} ms"
                        f" x{e.count / n:g}" for e in host)
    return dict(ms=sum(e.self_device_time_total for e in ev) / 1e3 / n,
                ops=sum(e.count for e in ev) / n, host=summary,
                recorded=recorded, launched=launched)


def busy_share(busy, wall_ms: float) -> str:
    """The busy share of ``wall_ms`` per request, with how many of the
    port's kernel launches CUPTI recorded."""
    text = (f"busy share {busy['ms'] / wall_ms:.3f} ({busy['recorded']} of "
            f"{busy['launched']} kernel launches recorded")
    if busy["recorded"] < busy["launched"]:
        text += "; records dropped: the share is unscaled"
    return text + ")"


def serve_path(path, engine, requests, queries):
    """One serving path (codec): a warm-up outside the counted run, then
    16 re-rank requests and 8 top-k queries with every launch count zeroed
    just before and read just after; each of the path's kernels must have
    been launched.  Then one profiled replay of each loop."""
    serve_batches(engine, requests[:1])        # library load, allocator
    serve_retrieval(engine, queries[:1], TOP_K)
    for fn in COUNTERS.values():
        fn.launches = 0
    scores, stats = serve_batches(engine, requests)
    hits, rstats = serve_retrieval(engine, queries, TOP_K)
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    log(f"phase 3 [{path}]: launches on the main path {launches}")
    for name in PATH_KERNELS[path]:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the {path} "
                                 "path")
    log(f"phase 3 [{path}]: serve_batches {N_REQUESTS} x ({Q_SLOTS} slots, "
        f"{N_CAND} candidates): p50 {stats.p50_ms:.3f} ms p95 "
        f"{stats.p95_ms:.3f} ms")
    log(f"phase 3 [{path}]: serve_retrieval {N_RETRIEVE} x top-{TOP_K}: "
        f"p50 {rstats.p50_ms:.3f} ms p95 {rstats.p95_ms:.3f} ms")
    for what, run, n, wall in (
            ("serve_batches", lambda: serve_batches(engine, requests),
             N_REQUESTS, stats.ms_per_request),
            ("serve_retrieval", lambda: serve_retrieval(engine, queries,
                                                        TOP_K),
             N_RETRIEVE, rstats.ms_per_request)):
        busy = device_busy(run, n)
        log(f"phase 3 [{path}]: {what}: device busy {busy['ms']:.4f} ms "
            f"per request of {wall:.4f} ms wall, {busy_share(busy, wall)}, "
            f"{busy['ops']:.1f} device ops per request; most host self "
            f"time per request (profiled): {busy['host']}")
    return scores, hits, launches


def check_packed_paths(index, packed, requests, queries, results, dev):
    """``packed`` serves exactly what the raw path serves; ``packed-q8``
    M stays within max(scale) / 2 of the exact M with the same sparsity,
    and its top-10 holds >= 90% of the raw path's."""
    scores, hits = results["none"]
    p_scores, p_hits = results["packed"]
    for i, (s, p) in enumerate(zip(scores, p_scores)):
        if not np.array_equal(s, p):
            raise AssertionError(f"request {i}: packed scores != raw "
                                 f"(max |diff| {np.abs(s - p).max()})")
    for i, ((s, d), (ps, pd)) in enumerate(zip(hits, p_hits)):
        if not (np.array_equal(d, pd) and np.array_equal(s, ps)):
            raise AssertionError(f"query {i}: packed top-{TOP_K} != raw")
    log(f"phase 3: packed scores and top-{TOP_K} ids == the raw path's "
        "(bitwise)")
    q8 = packed["packed-q8"]
    bound = float(q8.value_scale.max()) / 2 + 1e-6
    err = 0.0
    for q, docs in requests:
        qt, dt = torch.from_numpy(q).to(dev), torch.from_numpy(docs).to(dev)
        exact = index.qd_matrix(qt, dt)
        approx = q8.qd_matrix(qt, dt)
        err = max(err, (approx - exact).abs().max().item())
        if err > bound:
            raise AssertionError(f"packed-q8 M off by {err} > {bound}")
        if bool(((exact == 0) & (approx != 0)).any()) or not torch.equal(
                exact.flatten(2).ne(0).any(-1),
                approx.flatten(2).ne(0).any(-1)):
            raise AssertionError("packed-q8 M has another sparsity")
    q_hits = results["packed-q8"][1]
    recall = np.mean([len(set(d[:10].tolist()) & set(qd[:10].tolist())) / 10
                      for (_, d), (_, qd) in zip(hits, q_hits)])
    log(f"phase 3: packed-q8 M within {err:.3g} of exact (bound "
        f"max(scale)/2 = {bound:.3g}), same pairs found; recall@10 vs raw "
        f"{recall:.3f}")
    if recall < 0.9:
        raise AssertionError(f"packed-q8 recall@10 {recall} < 0.9")


def phase3(index, packed, rng, dev, seed):
    spec = get_retriever("knrm")
    params = spec.init(torch.Generator().manual_seed(seed), N_B,
                       index.functions, device=dev)
    engine = SeineEngine(index, "knrm", params)
    requests = [(draw_query(rng, rng.randint(3, Q_SLOTS + 1)),
                 rng.choice(N_DOCS, N_CAND, replace=False).astype(np.int32))
                for _ in range(N_REQUESTS)]
    queries = [draw_query(rng, rng.randint(2, Q_SLOTS + 1))
               for _ in range(N_RETRIEVE)]
    scores, hits, launches = serve_path("none", engine, requests, queries)
    results = {"none": (scores, hits)}
    path_launches = {"none": launches}
    engines = {"none": engine}
    for codec in CODECS:
        engines[codec] = SeineEngine(packed[codec], "knrm", params,
                                     codec=codec)
        s, h, path_launches[codec] = serve_path(codec, engines[codec],
                                                requests, queries)
        results[codec] = (s, h)
    check_packed_paths(index, packed, requests, queries, results, dev)
    # host times spread between paths run one after another: a second
    # round in the reverse order, with the raw K=4 partition beside them
    # (the same shards as the packed paths, codec "none")
    engines["none K=4"] = SeineEngine(packed["none"], "knrm", params)
    for path in ("none K=4", "packed-q8", "packed", "none"):
        _, st = serve_batches(engines[path], requests)
        _, rst = serve_retrieval(engines[path], queries, TOP_K)
        log(f"phase 3 [{path}]: second round: serve_batches p50 "
            f"{st.p50_ms:.3f} ms p95 {st.p95_ms:.3f} ms, serve_retrieval "
            f"p50 {rst.p50_ms:.3f} ms p95 {rst.p95_ms:.3f} ms")

    # outputs: shapes, finiteness, agreement with the plain path
    for (q, docs), s in zip(requests, scores):
        assert s.shape == (N_CAND,) and np.isfinite(s).all()
    for i in (0, 1):
        q, docs = requests[i]
        want = reference_scores(engine, torch.from_numpy(q).to(dev),
                                torch.from_numpy(docs).to(dev))
        np.testing.assert_allclose(scores[i], want, rtol=1e-5, atol=1e-6)
    for s, d in hits:
        assert s.shape == d.shape == (TOP_K,) and np.isfinite(s).all()
        assert (np.diff(s) <= 0).all() and len(set(d.tolist())) == TOP_K
        assert ((d >= 0) & (d < N_DOCS)).all()
    all_docs = torch.arange(N_DOCS, dtype=torch.int32, device=dev)
    for i in (0, 1):
        q = torch.from_numpy(queries[i]).to(dev)
        brute = np.concatenate([
            reference_scores(engine, q, all_docs[lo:lo + 8192])
            for lo in range(0, N_DOCS, 8192)])
        order = np.argsort(-brute, kind="stable")[:TOP_K]
        s, d = hits[i]
        np.testing.assert_allclose(s, brute[order], rtol=1e-5, atol=1e-6)
        kth = brute[order[-1]]
        must = order[brute[order] > kth + 1e-5 * abs(kth) + 1e-6]
        missing = set(must.tolist()) - set(d.tolist())
        if missing:
            raise AssertionError(f"retrieval missed {sorted(missing)[:5]}")
        agree = len(set(d.tolist()) & set(order.tolist())) / TOP_K
        log(f"phase 3: query {i} top-{TOP_K} vs brute force: recall "
            f"{agree:.4f}, scores within rtol 1e-5")
    return requests, queries, path_launches


def events_ms(fns, iters: int) -> float:
    """Mean time of one call, host launch cost included: CUDA events
    around ``iters`` calls cycling through ``fns``, after a warm-up."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fns, iters: int, kernel: str, cold: bool = False):
    """(mean device ms per launch, launches recorded) of the kernels whose
    name contains ``kernel``, over ``iters`` calls that launch one each
    (CUPTI, through torch.profiler), or None when the profiler records
    none.  The mean is over the launches CUPTI recorded: late in this
    long script it was seen to drop kernel records on an H100 (a
    flash_attn window summed to 80% of what CUDA events measured for the
    same launches), so dividing by the calls made would undercount.  With
    ``cold``, 64 MB (more than the card's 50 MB L2) are overwritten
    before every call, so each launch finds its inputs in device memory
    as a fresh request would; the overwrite is another kernel, which the
    sum leaves out."""
    if cold:
        buf = torch.empty(16 << 20, dtype=torch.float32, device="cuda")
        fns = [lambda f=f: (buf.zero_(), f()) for f in fns]
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if kernel in e.key]
    us = sum(e.self_device_time_total for e in ev)
    n = sum(e.count for e in ev)
    return (us / 1e3 / n, n) if us > 0 and n > 0 else None


def timed(fns, iters: int, kernel: str, cold: bool = False):
    """(device ms, how it was timed, ms with host launch cost)."""
    call = events_ms(fns, iters)
    dev = device_ms(fns, iters, kernel, cold=cold)
    if dev is None:
        return call, "events", call
    return dev[0], f"cupti, {dev[1]} of {iters} launches recorded", call


def bound(n_bytes: float, n_ops: float, ops_per_s: float = FP32_FLOPS_PER_S):
    """The least time for the work: bytes over the HBM rate or flops
    over the peak rate of their type (fp32 unless given), whichever is
    larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def time_lookup(index, requests, dev):
    """csr_lookup at the serving shape, one input set per request: 16 x
    6,000 cells x 720 B of rows overflow the 50 MB L2, as a stream of
    fresh requests would."""
    row = N_B * len(ZIPF_FUNCTIONS)
    inputs = [lookup_inputs(index, torch.from_numpy(q).to(dev),
                            torch.from_numpy(d).to(dev))
              for q, d in requests]
    fns = [lambda a=a: csr_lookup_kernel(*a, tile=256) for a in inputs]
    ms, how, call_ms = timed(fns, 160, "csr_lookup_kernel")
    # cold L2, as the packed lookups are timed
    ms_cold = timed(fns, 160, "csr_lookup_kernel", cold=True)[0]
    plain_ms = events_ms([lambda a=a: csr_lookup_plain(*a, tile=256)
                          for a in inputs], 16)
    err, found = 0.0, 0
    for i, a in enumerate(inputs):
        got = csr_lookup_kernel(*a, tile=256)
        want = csr_lookup_plain(*a, tile=256)
        assert_equal(got, want, f"request {i} csr_lookup")
        err = max(err, (got - want).abs().max().item())
        found += int((got != 0).reshape(got.shape[0], got.shape[1], -1)
                     .any(-1).sum())
    # yardstick: one searchsorted over the globally sorted (term, doc) key
    # computes the same positions (not the rows)
    counts = (index.term_offsets[1:] - index.term_offsets[:-1]).long()
    terms = torch.repeat_interleave(
        torch.arange(VOCAB, device=dev, dtype=torch.int64), counts)
    keys = terms * (N_DOCS + 1) + index.doc_ids.long()
    probes = [torch.from_numpy(q).to(dev).long().clamp(min=0)[None]
              * (N_DOCS + 1) + torch.from_numpy(d).to(dev).long()[:, None]
              for q, d in requests]
    lib_ms, _, _ = timed([lambda p=p: torch.searchsorted(keys, p)
                          for p in probes], 160, "earchsorted")
    # bytes the data needs: each cell's probes (the fence bisect over its
    # term's own tiles, the in-tile bisect and the hit check, 4 B each),
    # the found rows read, every row written, the candidates and the
    # routing
    cells = N_CAND * Q_SLOTS
    n_probes = 0
    for _, _, lo, hi, *_ in inputs:
        for t_lo, t_hi in zip(lo.tolist(), hi.tolist()):
            n_tiles = max((t_hi - 1) // 256, t_lo // 256) - t_lo // 256 + 1
            n_probes += N_CAND * (n_tiles.bit_length()
                                  + min(256, t_hi - t_lo).bit_length() + 1)
    n_bytes = ((n_probes * 4 + found * row * 4) / len(inputs)
               + cells * row * 4 + N_CAND * 4 + Q_SLOTS * 12)
    b_ms, b_by = bound(n_bytes, 0)
    return dict(name="csr_lookup", ms=ms, timed_by=how, call_ms=call_ms,
                plain_ms=plain_ms, max_abs_err=err, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, ms_cold=ms_cold)


def time_scan(index, queries, scan_err, dev):
    """retrieve_windows: one launch per 1024-doc block, over the full
    scans of every retrieval query."""
    row = N_B * len(ZIPF_FUNCTIONS)
    to, dids, vals, t2s, rlo, rhi = stacked(index)
    calls, n_post = [], 0
    for q in queries:
        lo, hi = retrieve_lanes(torch.from_numpy(q).to(dev), to, t2s, rlo,
                                rhi, dids.shape[1])
        lo, hi = lo.contiguous(), hi.contiguous()
        n_post += int((hi - lo).sum())
        calls += [(lo, hi, blo) for blo in range(0, N_DOCS, 1024)]
    ms, how, call_ms = timed([lambda c=c: retrieve_windows_kernel(
        dids, vals, c[0], c[1], c[2], 1024, tile=256) for c in calls],
        len(calls), "retrieve_block_kernel")
    plain_ms = events_ms([lambda c=c: scan_block_ref(
        dids, vals, c[0], c[1], c[2], 1024) for c in calls[::16]],
        len(calls[::16]))
    # per launch: its block's postings read (row + id) and M written
    n_bytes = (n_post * (row * 4 + 4) / len(calls)
               + 1024 * Q_SLOTS * row * 4 + Q_SLOTS * 8)
    b_ms, b_by = bound(n_bytes, 0)
    return dict(name="retrieve_windows", ms=ms, timed_by=how,
                call_ms=call_ms, plain_ms=plain_ms, max_abs_err=scan_err,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def time_knrm(index, requests, knrm_err, dev):
    """knrm_pool at the serving shape, on the cos_norm KNRM builds."""
    q, d = requests[0]
    with torch.inference_mode():
        qt, dt = torch.from_numpy(q).to(dev), torch.from_numpy(d).to(dev)
        m = index.qd_matrix(qt, dt)
        seg_len = make_qmeta(index, qt, dt).seg_len
        mask = (seg_len > 0).float()
        cos_norm = torch.clamp(m[..., index.fn_index("cosine")]
                               / torch.clamp(seg_len, min=1.0)[:, None, :],
                               -1.0, 1.0).contiguous()
        ms, how, call_ms = timed([lambda: knrm_pool_kernel(cos_norm, mask)],
                                 200, "knrm_pool_kernel")
        plain_ms = events_ms([lambda: knrm_pool_ref(cos_norm, mask)], 50)
        got = knrm_pool_kernel(cos_norm, mask)
        want = knrm_pool_ref(cos_norm, mask)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        err = (got - want).abs().max().item()
    rows, k = N_CAND * Q_SLOTS, 11
    n_bytes = (rows * N_B + N_CAND * N_B + rows * k) * 4
    # per (row, segment, kernel): sub, div, 2 mul, exp, fma; log1p per sum
    b_ms, b_by = bound(n_bytes, rows * N_B * k * 7 + rows * k)
    return dict(name="knrm_pool", ms=ms, timed_by=how, call_ms=call_ms,
                plain_ms=plain_ms, max_abs_err=max(err, knrm_err),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def time_packed_lookup(pidx, requests, dev):
    """csr_lookup_packed at the serving shape over one codec's index,
    one input set per request, as :func:`time_lookup`."""
    row = N_B * len(ZIPF_FUNCTIONS)
    val_bytes = pidx._serve_values.element_size()
    inputs = [packed_args(pidx, torch.from_numpy(q).to(dev),
                          torch.from_numpy(d).to(dev)) for q, d in requests]
    # cold L2: the 16 requests' int8 rows (17 MB) would stay in the 50 MB
    # L2 across the timing loop, which a stream of fresh requests does not
    ms, how, call_ms = timed(
        [lambda a=a: csr_lookup_packed_kernel(*a, tile=PACK_TILE)
         for a in inputs], 160, "csr_lookup_packed_kernel", cold=True)
    plain_ms = events_ms([lambda a=a: csr_lookup_packed_plain(
        *a, tile=PACK_TILE) for a in inputs], 16)
    err, found = 0.0, 0
    for i, a in enumerate(inputs):
        got = csr_lookup_packed_kernel(*a, tile=PACK_TILE)
        want = csr_lookup_packed_plain(*a, tile=PACK_TILE)
        assert_equal(got, want, f"request {i} csr_lookup_packed")
        err = max(err, (got - want).abs().max().item())
        found += int((got != 0).reshape(got.shape[0], got.shape[1], -1)
                     .any(-1).sum())
    # bytes the data needs, per cell: the fence bisect over its term's own
    # tiles and the in-tile bisect plus the hit check (one 4-byte fence or
    # packed word per probe), the tile's (bits, base, word offset); the
    # found rows at their storage width, every f32 row written, the
    # candidates, the routing and the scales
    n_probes = 0
    for _, _, lo, hi, *_ in inputs:
        for t_lo, t_hi in zip(lo.tolist(), hi.tolist()):
            n_tiles = (max((t_hi - 1) // PACK_TILE, t_lo // PACK_TILE)
                       - t_lo // PACK_TILE + 1)
            n_probes += N_CAND * (n_tiles.bit_length() + 3
                                  + min(PACK_TILE, t_hi - t_lo).bit_length()
                                  + 1)
    cells = N_CAND * Q_SLOTS
    n_bytes = ((n_probes * 4 + found * row * val_bytes) / len(inputs)
               + cells * row * 4 + N_CAND * 4 + Q_SLOTS * 16)
    b_ms, b_by = bound(n_bytes, 0)
    return dict(ms=ms, timed_by=how, call_ms=call_ms, plain_ms=plain_ms,
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by)


def time_packed_scan(pidx, queries, dev):
    """retrieve_windows_packed: one launch per 1024-doc block over the
    full scans of every retrieval query, on one codec's index; the blocks
    the plain version is timed on are also held against it."""
    row = N_B * len(ZIPF_FUNCTIONS)
    val_bytes = pidx._serve_values.element_size()
    args = (pidx._packed(), pidx.fences, pidx._serve_values)
    bits = pidx.tile_bits.long()
    calls, n_post, id_bits, n_tiles = [], 0, 0, 0
    for q in queries:
        lo, hi, scale = packed_lanes(pidx, torch.from_numpy(q).to(dev))
        for l, (a, b) in enumerate(zip(lo.view(-1).tolist(),
                                       hi.view(-1).tolist())):
            if b > a:
                k = l % pidx.n_shards
                p = torch.arange(a, b, device=dev) - k * pidx.nmax
                id_bits += int(bits[k, p // PACK_TILE].sum())
                n_tiles += int((p[-1] // PACK_TILE - p[0] // PACK_TILE) + 1)
                n_post += b - a
        calls += [(scale, lo, hi, blo) for blo in range(0, N_DOCS, 1024)]
    ms, how, call_ms = timed([lambda c=c: retrieve_windows_packed_kernel(
        *args, *c, 1024, tile=PACK_TILE) for c in calls], len(calls),
        "retrieve_block_packed_kernel")
    plain_ms = events_ms([lambda c=c: scan_block_packed_ref(
        *args, *c, 1024, tile=PACK_TILE) for c in calls[::16]],
        len(calls[::16]))
    err = 0.0
    for c in calls[::16]:
        got = retrieve_windows_packed_kernel(*args, *c, 1024, tile=PACK_TILE)
        want = scan_block_packed_ref(*args, *c, 1024, tile=PACK_TILE)
        assert_equal(got, want, f"retrieve_windows_packed blo={c[3]}")
        err = max(err, (got - want).abs().max().item())
    # per launch: its block's postings (packed id bits, the touched tiles'
    # 12 bytes of metadata, the rows at their storage width) read and M
    # written, plus the lanes and their scales
    n_bytes = ((id_bits / 8 + n_tiles * 12 + n_post * row * val_bytes)
               / len(calls) + 1024 * Q_SLOTS * row * 4
               + Q_SLOTS * pidx.n_shards * 12)
    b_ms, b_by = bound(n_bytes, 0)
    return dict(ms=ms, timed_by=how, call_ms=call_ms, plain_ms=plain_ms,
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by)


def phase4(index, packed, requests, queries, launches, p2, dev):
    rows = [dict(time_lookup(index, requests, dev), path="none"),
            dict(time_scan(index, queries, p2["scan_err"], dev), path="none"),
            dict(time_knrm(index, requests, p2["knrm_err"], dev),
                 path="none")]
    for name, timer, inputs in (
            ("csr_lookup_packed", time_packed_lookup, requests),
            ("retrieve_windows_packed", time_packed_scan, queries)):
        by_codec = {c: timer(packed[c], inputs, dev) for c in CODECS}
        rows.append(dict(by_codec["packed"], name=name, path="packed",
                         library_ms=None, q8=by_codec["packed-q8"]))
    out = []
    for r in rows:
        lib = "knrm_pool" if r["name"] == "knrm_pool" else "csr_lookup"
        paths = ("none",) if r["path"] == "none" else CODECS
        out.append(dict(r, route="cuda",
                        source=KERNEL_SOURCE.format(lib, lib),
                        replaces=TPU_KERNELS[r["name"]],
                        launches=sum(launches[p][r["name"]] for p in paths),
                        launches_by_path={p: launches[p][r["name"]]
                                          for p in paths}))
        for tag, m in (("", r), (" [packed-q8]", r.get("q8"))):
            if m is None:
                continue
            log(f"phase 4: {r['name']}{tag}: {m['ms']:.4f} ms "
                f"({m['timed_by']}; {m['call_ms']:.4f} ms with launch "
                f"cost), plain {m['plain_ms']:.4f} ms, bound "
                f"{m['bound_ms']:.5f} ms ({m['bound_by']}), library "
                f"{r['library_ms']}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the offline build
# ---------------------------------------------------------------------------

def build_corpus(seed: int):
    """SEINE_LETOR's synthetic corpus at BUILD_DOCS docs, its middle-80%
    vocabulary and TextTiling segments, on the host (numpy)."""
    cfg = dataclasses.replace(SEINE_LETOR, n_docs=BUILD_DOCS,
                              n_segments=BUILD_N_B, embed_dim=BUILD_DE)
    t0 = time.perf_counter()
    ds = generate(cfg, seed=seed)
    t_gen = time.perf_counter() - t0
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens,
                             keep_frac=cfg.vocab_keep_frac)
    slot = [vocab.map_tokens(d) for d in ds.docs]
    t_vocab = time.perf_counter() - t0 - t_gen
    toks, segs = segment_corpus(slot, cfg.n_segments, max_len=BUILD_MAX_LEN,
                                window=cfg.tile_window,
                                smooth=cfg.tile_smooth)
    secs = time.perf_counter() - t0
    raw_len = np.array([d.size for d in slot])
    in_vocab = np.array([int((d >= 0).sum()) for d in slot])
    kept = (toks >= 0).sum(1)
    uniq = np.array([np.unique(r[r >= 0]).size for r in toks[:2000]])
    log(f"phase 5: corpus {BUILD_DOCS} docs, |v| = {vocab.size}, host "
        f"{secs:.2f}s (generate {t_gen:.2f}s, vocabulary {t_vocab:.2f}s, "
        f"TextTiling {secs - t_gen - t_vocab:.2f}s); docs longer than "
        f"max_len={BUILD_MAX_LEN}: {(raw_len > BUILD_MAX_LEN).mean():.4f} "
        f"(raw length mean {raw_len.mean():.1f}), in-vocabulary tokens "
        f"kept {kept.sum() / max(in_vocab.sum(), 1):.4f} (mean "
        f"{kept.mean():.1f}, max {kept.max()} per doc), unique terms per "
        f"doc in the first 2,000: mean {uniq.mean():.1f}, max {uniq.max()}")
    return cfg, ds, vocab, toks, segs, secs


def batch_inputs(builder, toks, segs, start: int, dev):
    """The seg_interact kernel's arguments for the build batch at
    ``start``, made as the build makes them (stage 1, then
    ``seg_interact_inputs``)."""
    tb = torch.from_numpy(toks[start:start + BUILD_BATCH]).to(dev)
    sb = torch.from_numpy(segs[start:start + BUILD_BATCH]).to(dev)
    ub = make_unique_terms_fn(BUILD_MAX_UNIQ)(tb)
    return seg_interact_inputs(tb, sb, ub, builder.provider.table(),
                               builder.cfg.n_segments)


def check_seg_interact(builder, toks, segs, seed, dev):
    """The kernel against its plain version on the card: a full build
    batch (twice, bitwise: it is deterministic), the JAX-signature sweep
    with an empty last segment, which must give zeros, at the table's
    N(0, 1/De) scale and at the reference test's unit scale.  Returns the
    largest |diff| at each scale."""
    n_b = builder.cfg.n_segments
    args = batch_inputs(builder, toks, segs, 0, dev)
    got = seg_interact_kernel(*args, n_b)
    again = seg_interact_kernel(*args, n_b)
    want = seg_interact_plain(*args, n_b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **SEG_TOL)
    if not torch.equal(got, again):
        raise AssertionError("seg_interact is not deterministic")
    if bool((got[args[3] < 0] != 0).any()):
        raise AssertionError("seg_interact wrote a pad term's row")
    err = (got - want).abs().max().item()
    log(f"phase 5: seg_interact == plain at rtol 1e-4/atol 1e-5 on a build "
        f"batch {tuple(args[0].shape[:2])} x {tuple(args[1].shape[1:])}, "
        f"S={n_b} (max |diff| {err:.3g}); bitwise run to run")
    g = torch.Generator(device=dev).manual_seed(seed)
    unit_err = 0.0
    for unit, tol in ((False, SEG_TOL), (True, SEG_UNIT_TOL)):
        for v, n_seg, ls, de in SEG_SWEEP:
            scale = 1.0 if unit else de ** -0.5
            ev = torch.randn(v, de, generator=g, device=dev) * scale
            st = torch.randn(n_seg, ls, de, generator=g, device=dev) * scale
            lens = torch.randint(0, ls + 1, (n_seg,), generator=g,
                                 device=dev)
            lens[-1] = 0
            mask = (torch.arange(ls, device=dev)[None]
                    < lens[:, None]).float()
            got = seg_interact(ev, st, mask)
            want = seg_interact_plain(*flatten_segments(ev, st, mask),
                                      n_seg)[0]
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **tol)
            if bool((got[:, -1] != 0).any()):
                raise AssertionError("an empty segment gave nonzero values")
            diff = (got - want).abs().max().item()
            if unit:
                unit_err = max(unit_err, diff)
            else:
                err = max(err, diff)
    log(f"phase 5: seg_interact == plain over the JAX-signature sweep "
        f"{SEG_SWEEP}; empty segments give zeros; N(0, 1/De) rows at rtol "
        f"1e-4/atol 1e-5 (max |diff| {err:.3g}), unit-scale rows at rtol "
        f"1e-3/atol 1e-4 (max |diff| {unit_err:.3g})")
    return err, unit_err


def check_cpu_build(builder, toks, segs):
    """The first BUILD_CHECK_DOCS docs built on the card against the
    same build on the CPU (same vocabulary, table and parameters): run
    term ids, doc ids and boundaries bitwise, values at rtol 1e-4 /
    atol 1e-5."""
    cpu = IndexBuilder(
        builder.cfg, builder.vocab,
        HashProvider(builder.vocab.size, builder.cfg.embed_dim,
                     table=builder.provider.table().cpu(), device="cpu"),
        ip=builder.ip, device="cpu")
    n = BUILD_CHECK_DOCS
    kw = dict(batch_size=BUILD_BATCH, max_uniq=BUILD_MAX_UNIQ)
    got, _ = builder.pipeline.stream_runs(toks[:n], segs[:n], **kw)
    want, _ = cpu.pipeline.stream_runs(toks[:n], segs[:n], **kw)
    if [r.n_rows for r in got.runs] != [r.n_rows for r in want.runs]:
        raise AssertionError("run boundaries differ from the CPU build")
    err = 0.0
    for r, w in zip(got.runs, want.runs):
        (t, d, v), (wt, wd, wv) = r.load(), w.load()
        if not (np.array_equal(t, wt) and np.array_equal(d, wd)):
            raise AssertionError("run ids differ from the CPU build")
        np.testing.assert_allclose(v, wv, **SEG_TOL)
        err = max(err, float(np.abs(v - wv).max()))
    log(f"phase 5: the card's build of {n} docs == the CPU build: "
        f"{len(got.runs)} runs, {sum(r.n_rows for r in got.runs)} rows, "
        f"ids and boundaries bitwise, values within rtol 1e-4/atol 1e-5 "
        f"(max |diff| {err:.3g})")


def check_on_the_fly(pidx, noindex, toks, rng, dev):
    """Indexed == on-the-fly: for stored pairs of BUILD_PAIR_DOCS docs, M
    looked up in the built index equals M recomputed by the No-Index
    engine at atol 1e-5 (tests/test_seine_core.py's bar)."""
    err = 0.0
    for d in rng.choice(toks.shape[0], BUILD_PAIR_DOCS, replace=False):
        present = np.unique(toks[d][toks[d] >= 0])
        q = np.full(Q_SLOTS, -1, np.int32)
        sel = rng.choice(present, size=min(Q_SLOTS - 1, present.size),
                         replace=False)
        q[:sel.size] = sel
        qt = torch.from_numpy(q).to(dev)
        dt = torch.tensor([int(d)], dtype=torch.int32, device=dev)
        looked = pidx.qd_matrix(qt, dt)
        on_fly = noindex.qd_matrix(qt, dt)
        torch.cuda.synchronize()
        err = max(err, (looked - on_fly).abs().max().item())
        if err > 1e-5:
            raise AssertionError(f"indexed != on-the-fly for doc {d}: "
                                 f"{err}")
        if not bool(looked.flatten(2).ne(0).any(-1)[0, :sel.size].all()):
            raise AssertionError(f"a stored pair of doc {d} is missing")
    log(f"phase 5: indexed == on-the-fly for the stored pairs of "
        f"{BUILD_PAIR_DOCS} docs (max |diff| {err:.3g}, bar 1e-5)")


def serve_built(pidx, noindex, engine, ds, vocab, seed):
    """The built index served: SeineEngine (KNRM) answers N_REQUESTS
    re-rank requests, the No-Index engine NOINDEX_REQUESTS of them; each
    path's launch counts are zeroed just before and read just after."""
    queries = pad_queries(ds.queries, vocab.map_tokens, q_len=Q_SLOTS)
    crng = np.random.RandomState(seed)
    requests = [(queries[i], candidates_for_query(ds.qrels[i], crng, N_CAND)
                 .astype(np.int32)) for i in range(N_REQUESTS)]
    serve_batches(engine, requests[:1])        # warm-up, uncounted
    serve_batches(noindex, requests[:1])
    counts = {}
    out = {}
    for path, eng, reqs, need in (
            ("indexed", engine, requests, ("csr_lookup", "knrm_pool")),
            ("noindex", noindex, requests[:NOINDEX_REQUESTS],
             ("seg_interact", "embed_bag", "knrm_pool"))):
        for fn in COUNTERS.values():
            fn.launches = 0
        out[path] = serve_batches(eng, reqs)
        counts[path] = {n: fn.launches for n, fn in COUNTERS.items()}
        log(f"phase 5 [{path}]: launches {counts[path]}")
        for name in need:
            if counts[path][name] <= 0:
                raise AssertionError(f"{name} was not launched serving "
                                     f"the built index ({path})")
        st = out[path][1]
        log(f"phase 5 [{path}]: serve_batches {len(reqs)} x ({Q_SLOTS} "
            f"slots, {N_CAND} candidates): p50 {st.p50_ms:.3f} ms p95 "
            f"{st.p95_ms:.3f} ms")
    scores, noindex_scores = out["indexed"][0], out["noindex"][0]
    err = 0.0
    for s, n in zip(scores, noindex_scores):
        assert s.shape == (N_CAND,) and np.isfinite(s).all()
        np.testing.assert_allclose(n, s, **SEG_TOL)
        err = max(err, float(np.abs(n - s).max()))
    log(f"phase 5: No-Index scores == indexed scores at rtol 1e-4/atol "
        f"1e-5 on {NOINDEX_REQUESTS} requests (max |diff| {err:.3g})")
    return counts


def round_trip(pidx):
    """save_index of the built partition, then load_index: every array
    equal."""
    t0 = time.perf_counter()
    save_index(INDEX_DIR, pidx)
    t_save = time.perf_counter() - t0
    on_disk = sum(os.path.getsize(os.path.join(INDEX_DIR, f))
                  for f in os.listdir(INDEX_DIR))
    t0 = time.perf_counter()
    back = load_index(INDEX_DIR, device=pidx.device)
    t_load = time.perf_counter() - t0
    shutil.rmtree(INDEX_DIR)
    for n in ("term_offsets", "doc_ids", "values", "fences", "term_to_shard",
              "range_lo", "range_hi", "split_term", "split_doc", "idf",
              "doc_len", "seg_len"):
        a, b = getattr(back, n), getattr(pidx, n)
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            raise AssertionError(f"save_index/load_index changed {n}")
    log(f"phase 5: save_index -> load_index round trip equal, {on_disk} "
        f"bytes on disk, save {t_save:.2f}s, load {t_load:.2f}s")


def time_seg_interact(builder, toks, segs, launches, err, dev, **extra):
    """seg_interact at the build shape over 16 batches of fresh docs, its
    plain version, and torch.bmm of the score product alone (context,
    not a yardstick: it skips the epilogues).  The bound counts what the
    function needs once: the embedding rows of valid terms (id >= 0) and
    of kept tokens (segment in [0, S)), the whole seg and term-id arrays
    and the whole output; and 2 * U_b * L_b * De flops per doc for its
    valid terms and kept tokens."""
    n_b = builder.cfg.n_segments
    n_batches = max(1, min(16, toks.shape[0] // BUILD_BATCH))
    inputs = [batch_inputs(builder, toks, segs, i * BUILD_BATCH, dev)
              for i in range(n_batches)]
    flops = n_bytes = 0
    for e_term, e_tok, seg, term_ids in inputs:
        u = (term_ids >= 0).sum(1).double()
        length = ((seg >= 0) & (seg < n_b)).sum(1).double()
        de = e_term.shape[2]
        flops += 2 * float((u * length).sum()) * de
        n_bytes += float(u.sum() + length.sum()) * de * e_term.element_size()
        n_bytes += seg.numel() * 4 + term_ids.numel() * 4
        n_bytes += e_term.shape[0] * e_term.shape[1] * n_b * 3 * 4
    fns = [lambda a=a: seg_interact_kernel(*a, n_b) for a in inputs]
    ms, how, call_ms = timed(fns, 160, "seg_interact_kernel")
    plain_ms = events_ms([lambda a=a: seg_interact_plain(*a, n_b)
                          for a in inputs], len(inputs))
    bmm_ms = events_ms([lambda a=a: torch.bmm(a[0], a[1].transpose(1, 2))
                        for a in inputs], 160)
    for a in inputs:
        got, want = seg_interact_kernel(*a, n_b), seg_interact_plain(*a, n_b)
        torch.testing.assert_close(got, want, **SEG_TOL)
        err = max(err, (got - want).abs().max().item())
    b_ms, b_by = bound(n_bytes / len(inputs), flops / len(inputs))
    # diagnostic: the first batch with every term slot and token live, so
    # every block of the grid multiplies whole tiles
    a = inputs[0]
    n_l = a[1].shape[1]
    live_seg = (torch.arange(n_l, device=dev) * n_b // n_l).to(torch.int32)
    live = (a[0], a[1], live_seg.expand(a[2].shape).contiguous(),
            torch.zeros_like(a[3]))
    live_ms = timed([lambda: seg_interact_kernel(*live, n_b)], 50,
                    "seg_interact_kernel")[0]
    live_flops = 2.0 * a[0].shape[0] * a[0].shape[1] * n_l * a[0].shape[2]
    log(f"phase 5: seg_interact {ms:.4f} ms per build batch ({how}; "
        f"{call_ms:.4f} ms with launch cost) = "
        f"{flops / len(inputs) / ms / 1e9:.2f} TFLOP/s on the valid "
        f"(term, token) pairs; plain {plain_ms:.4f} ms; bound "
        f"{b_ms:.5f} ms ({b_by}); torch.bmm of the scores alone "
        f"{bmm_ms:.4f} ms; the same batch with all {a[0].shape[1]} term "
        f"slots and {n_l} tokens live {live_ms:.4f} ms = "
        f"{live_flops / live_ms / 1e9:.2f} TFLOP/s")
    return dict(name="seg_interact", ms=ms, timed_by=how, call_ms=call_ms,
                plain_ms=plain_ms, max_abs_err=err, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, route="cuda",
                source=KERNEL_SOURCE.format("seg_interact", "seg_interact"),
                replaces=TPU_KERNELS["seg_interact"],
                launches=launches["build"],
                launches_by_path=launches, bmm_ms=bmm_ms,
                all_live_ms=live_ms, **extra)


def build_embed_bag_calls(builder, toks, segs, n_docs: int):
    """The embed_bag kernel's arguments in the build's own calls over the
    first ``n_docs`` docs: stages 1-3 run once more with the kernel's
    wrapper recording them (and still launching).  Returns ``(mix,
    lcp)``: the provider mix's calls and log_cond_prob's, in batch
    order."""
    calls = []
    wrapped = embed_bag_ops.embed_bag_kernel

    def record(table, idx, ptr):
        calls.append((table, idx, ptr))
        return wrapped(table, idx, ptr)

    embed_bag_ops.embed_bag_kernel = record
    try:
        builder.pipeline.stream_runs(toks[:n_docs], segs[:n_docs],
                                     batch_size=BUILD_BATCH,
                                     max_uniq=BUILD_MAX_UNIQ)
    finally:
        embed_bag_ops.embed_bag_kernel = wrapped
    table = builder.provider.table()
    mix = [c for c in calls if c[0] is table]
    lcp = [c for c in calls if c[0] is not table]
    if len(mix) != len(lcp):
        raise AssertionError(f"{len(mix)} provider-mix calls and "
                             f"{len(lcp)} log_cond_prob calls")
    return mix, lcp


def check_embed_bag(mix, lcp, seed, dev):
    """The kernel against its plain version on the card: one build
    batch's two calls (bitwise run to run), then the JAX-signature sweep
    of tests/test_kernels.py with empty bags, -1 entries and ids past
    the table, in float32 and bf16, at rtol 1e-5 / atol 1e-6.  Returns
    the largest |diff| and whether every output was bitwise equal."""
    err, bitwise = 0.0, True
    for what, (table, idx, ptr) in (("provider mix", mix[0]),
                                    ("log_cond_prob", lcp[0])):
        got = embed_bag_kernel(table, idx, ptr)
        again = embed_bag_kernel(table, idx, ptr)
        want = embed_bag_plain(table, idx, ptr)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **EB_TOL)
        if not torch.equal(got, again):
            raise AssertionError("embed_bag is not deterministic")
        bitwise &= torch.equal(got, want)
        err = max(err, (got - want).abs().max().item())
        live = int((idx >= 0).sum())
        log(f"phase 5: embed_bag == plain on the build's {what} call: "
            f"table {tuple(table.shape)}, {idx.shape[0]} indices "
            f"({live} live), {ptr.shape[0] - 1} bags (max |diff| "
            f"{(got - want).abs().max().item():.3g})")
    rng = np.random.RandomState(seed)
    for v, d, b, maxbag in EB_SWEEP:
        for dt in (torch.float32, torch.bfloat16):
            lens = rng.randint(0, maxbag, b)
            lens[-1] = 0                                   # an empty bag
            nnz = max(int(lens.sum()), 1)
            offsets = np.concatenate([[0], np.cumsum(lens)])[:-1]
            idx = rng.randint(-1, v + 2, nnz).astype(np.int32)
            table = torch.from_numpy(rng.standard_normal((v, d))
                                     .astype(np.float32)).to(dev, dt)
            idx_t = torch.from_numpy(idx).to(dev)
            ptr = bag_ptr_from_offsets(torch.from_numpy(offsets).to(dev),
                                       nnz, b)
            got = embed_bag_kernel(table, idx_t, ptr)
            want = embed_bag_plain(table, idx_t, ptr)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **EB_TOL)
            if bool((got[-1] != 0).any()):
                raise AssertionError("an empty bag gave nonzero values")
            bitwise &= torch.equal(got, want)
            err = max(err, (got.float() - want.float()).abs().max().item())
    log(f"phase 5: embed_bag == plain over the JAX-signature sweep "
        f"{EB_SWEEP} in float32 and bf16 (empty bags, -1 and past-table "
        f"ids): max |diff| {err:.3g}, bitwise {bitwise}")
    return err, bitwise


def embed_bag_cost(table, idx, ptr):
    """Bytes the call must move: the distinct live rows read once, the
    indices and bounds, and the bags written."""
    live = idx[idx >= 0].long().clamp(max=table.shape[0] - 1)
    rows = int(torch.unique(live).numel())
    n_bags = ptr.shape[0] - 1
    return ((rows + n_bags) * table.shape[1] * table.element_size()
            + idx.numel() * 4 + ptr.numel() * 4)


def library_embedding_bag(table, idx, ptr):
    """``F.embedding_bag(mode="sum")`` over the same bags, with the
    skipped entries dropped first (it has no skip id): the library call
    that computes the same function."""
    n_bags = ptr.shape[0] - 1
    pos = torch.arange(idx.shape[0], device=idx.device)
    bag = torch.searchsorted(ptr[1:].long(), pos, right=True)
    keep = idx >= 0
    counts = torch.bincount(bag[keep], minlength=n_bags)[:n_bags]
    offsets = torch.cumsum(counts, 0) - counts
    rows = idx[keep].long().clamp(max=table.shape[0] - 1)
    return lambda: torch.nn.functional.embedding_bag(
        rows, table, offsets, mode="sum")


def time_embed_bag(mix, lcp, launches, err, bitwise, dev):
    """embed_bag at the build's two shapes over up to 16 batches each
    (CUPTI); its plain version; ``F.embedding_bag`` (the library
    yardstick, never used by the port); the bound: bytes over 3.35
    TB/s (one add per value read is far below the float32 rate)."""
    out = {}
    for what, calls in (("mix", mix), ("lcp", lcp)):
        ms, how, call_ms = timed([lambda c=c: embed_bag_kernel(*c)
                                  for c in calls], 160, "embed_bag_")
        plain_ms = events_ms([lambda c=c: embed_bag_plain(*c)
                              for c in calls[:4]], 4)
        libs = [library_embedding_bag(*c) for c in calls]
        for c, lib in zip(calls, libs):
            torch.testing.assert_close(lib(), embed_bag_kernel(*c), **EB_TOL)
        lib_ms = timed(libs, 160, "EmbeddingBag")[0]
        n_bytes = sum(embed_bag_cost(*c) for c in calls) / len(calls)
        b_ms, b_by = bound(n_bytes, 0)
        out[what] = dict(ms=ms, timed_by=how, call_ms=call_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
        t, idx, ptr = calls[0]
        log(f"phase 5: embed_bag ({what}: table {tuple(t.shape)}, "
            f"{idx.shape[0]} indices, {ptr.shape[0] - 1} bags): {ms:.4f} "
            f"ms ({how}; {call_ms:.4f} ms with launch cost); plain "
            f"{plain_ms:.4f} ms; F.embedding_bag {lib_ms:.4f} ms; bound "
            f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB)")
    row = dict(out["mix"], name="embed_bag", route="cuda",
               source=KERNEL_SOURCE.format("embed_bag", "embed_bag"),
               replaces=TPU_KERNELS["embed_bag"], launches=launches["build"],
               launches_by_path=launches, max_abs_err=err,
               bitwise=bitwise, log_cond_prob=out["lcp"])
    return row


def phase5(seed: int, dev, corpus=None):
    """The offline build at full width and MQ2007 scale (module doc), over
    ``corpus`` (``build_corpus``'s result; made here when not given)."""
    cfg, ds, vocab, toks, segs, _ = corpus or build_corpus(seed)
    provider = HashProvider(vocab.size, cfg.embed_dim,
                            generator=torch.Generator().manual_seed(seed),
                            device=dev)
    ip = init_interaction_params(torch.Generator().manual_seed(seed + 1),
                                 cfg.embed_dim, device=dev)
    builder = IndexBuilder(cfg, vocab, provider, ip=ip, device=dev)
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    pidx = builder.build_partitioned(toks, segs, BUILD_K,
                                     batch_size=BUILD_BATCH,
                                     max_uniq=BUILD_MAX_UNIQ)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    built = {n: fn.launches for n, fn in COUNTERS.items()}
    st = builder.last_build_stats
    log(f"phase 5: build launches {built}")
    if built["seg_interact"] != st.n_batches:
        raise AssertionError(f"seg_interact launched {built['seg_interact']}"
                             f" times for {st.n_batches} batches")
    if built["embed_bag"] < 2 * st.n_batches:
        raise AssertionError(f"embed_bag launched {built['embed_bag']} "
                             f"times for {st.n_batches} batches (2 each)")
    stage = ", ".join(f"{k} {v:.2f}s" for k, v in st.stage_s.items())
    dev_ms = ", ".join(f"{k} {v / 1e3:.2f}s"
                       for k, v in st.stage_device_ms.items())
    log(f"phase 5: build_partitioned K={pidx.n_shards}: {st.n_docs} docs in "
        f"{wall:.2f}s ({st.n_docs / wall:.1f} docs/s end to end; stages "
        f"1-3 {st.build_s:.2f}s = {st.docs_per_s:.1f} docs/s), "
        f"{st.n_batches} batches; host seconds per stage: {stage}; device "
        f"time per stage: {dev_ms or 'not measured'}")
    log(f"phase 5: nnz {pidx.nnz}, posting_nbytes {pidx.posting_nbytes}, "
        f"nmax {pidx.nmax}, split_term {pidx.split_term is not None}, peak "
        f"run {max(st.run_bytes)} bytes, {st.total_nnz / st.n_docs:.1f} "
        f"postings per doc")
    err, unit_err = check_seg_interact(builder, toks, segs, seed, dev)
    mix, lcp = build_embed_bag_calls(
        builder, toks, segs, min(16 * BUILD_BATCH, toks.shape[0]))
    eb_err, eb_bitwise = check_embed_bag(mix, lcp, seed, dev)
    check_cpu_build(builder, toks, segs)
    params = get_retriever("knrm").init(torch.Generator().manual_seed(seed),
                                        cfg.n_segments, builder.functions,
                                        device=dev)
    engine = SeineEngine(pidx, "knrm", params)
    noindex = NoIndexEngine(builder, pidx, toks, segs, "knrm", params)
    check_on_the_fly(pidx, noindex, toks, np.random.RandomState(seed), dev)
    served = serve_built(pidx, noindex, engine, ds, vocab, seed)
    round_trip(pidx)
    rows = [time_seg_interact(
        builder, toks, segs,
        {"build": built["seg_interact"],
         "noindex": served["noindex"]["seg_interact"]}, err, dev,
        unit_scale_max_abs_err=unit_err),
        time_embed_bag(mix, lcp, {"build": built["embed_bag"],
                                  "noindex": served["noindex"]["embed_bag"]},
                       eb_err, eb_bitwise, dev)]
    return rows, dict(pidx=pidx, engine=engine, ds=ds, vocab=vocab)




# ---------------------------------------------------------------------------
# phase 7: the serving front end over phase 5's index
# ---------------------------------------------------------------------------

def letor_requests(ds, vocab, seed: int, n: int):
    """``n`` LETOR re-rank requests of Q_SLOTS query slots x N_CAND
    candidates (``candidates_for_query``), cycling over the queries."""
    queries = pad_queries(ds.queries, vocab.map_tokens, q_len=Q_SLOTS)
    crng = np.random.RandomState(seed)
    return [(queries[i % len(queries)],
             candidates_for_query(ds.qrels[i % len(queries)], crng, N_CAND)
             .astype(np.int32)) for i in range(n)]


def metric(name: str) -> float:
    m = obs.REGISTRY.get(name)
    return m.get() if m is not None else 0.0


FE_METRICS = ("seine_frontend_batches_total",
              "seine_coalesce_pair_slots_total",
              "seine_coalesce_distinct_pairs_total",
              "seine_tile_cache_hits_total", "seine_tile_cache_misses_total",
              "seine_tile_cache_evictions_total",
              "seine_tile_cache_overflow_pairs_total",
              "seine_serve_slo_misses_total")


def open_loop(engine, requests, qps: float, seed: int, **kw):
    """One open-loop run of ``requests`` at ``qps`` through a fresh
    front end, closed when the run ends.  The front end first serves
    FE_MAX_BATCH requests, uncounted (its worker thread's first CUDA
    calls are slow), with its stats then reset.  Returns (result, the
    futures in submission order, wall seconds from the first submission
    to the last result, the obs counters' and the launch counts' rise
    over the run)."""
    fe = ServingFrontend(engine, max_batch=FE_MAX_BATCH,
                         batch_timeout_ms=FE_TIMEOUT_MS, slo_ms=FE_SLO_MS,
                         **kw)
    try:
        for f in [fe.submit(q, d) for q, d in requests[:FE_MAX_BATCH]]:
            f.result(timeout=120)
        fe.stats = type(fe.stats)()
        futures = []
        submit = fe.submit

        def keep(q, d):
            futures.append(submit(q, d))
            return futures[-1]

        fe.submit = keep
        before = {n: metric(n) for n in FE_METRICS}
        launched = {n: fn.launches for n, fn in COUNTERS.items()}
        t0 = time.perf_counter()
        res = run_open_loop(fe, requests, target_qps=qps, seed=seed,
                            timeout=120)
        wall = time.perf_counter() - t0
        delta = {n: metric(n) - before[n] for n in FE_METRICS}
        launched = {n: fn.launches - launched[n]
                    for n, fn in COUNTERS.items()}
    finally:
        fe.close(timeout=120)
    return res, futures, wall, delta, launched


def check_served(futures, want, what: str) -> int:
    """Every served future equals ``engine.score`` for its request,
    bitwise; returns how many were served."""
    served = 0
    for i, (f, w) in enumerate(zip(futures, want)):
        try:
            got = f.result(timeout=120)
        except DeadlineExceeded:
            continue
        if not np.array_equal(got, w):
            raise AssertionError(f"{what}: request {i} scores != "
                                 f"engine.score (max |diff| "
                                 f"{np.abs(got - w).max()})")
        served += 1
    return served


def phase7(ctx, seed: int, dev):
    """The front end over phase 5's K = 4 partition with KNRM: the
    closed-loop rate R of serve_batches, then FE_REQUESTS requests
    through run_open_loop at R and at R / 2 in each of FE_MODES, every
    served score
    bitwise equal to engine.score, with p50/p95, queue ms, goodput,
    batches, the dedupe ratio, the cache counters, launches per kernel
    and the busy share; then one swap_engine to a packed copy."""
    engine, pidx = ctx["engine"], ctx["pidx"]
    requests = letor_requests(ctx["ds"], ctx["vocab"], seed + 3,
                              FE_REQUESTS)
    want = []
    with torch.inference_mode():
        for q, d in requests:
            want.append(engine.score(q, d).cpu().numpy())
    _, closed = serve_batches(engine, requests[:FE_CLOSED])
    qps = 1e3 / closed.ms_per_request
    log(f"phase 7: closed loop serve_batches {FE_CLOSED} x ({Q_SLOTS} "
        f"slots, {N_CAND} candidates): {closed.ms_per_request:.4f} ms per "
        f"request (p50 {closed.p50_ms:.3f}, p95 {closed.p95_ms:.3f}) -> "
        f"offered rate R = {qps:.1f} requests/s")
    results = {}
    for frac in FE_RATES:
        for mode, kw in FE_MODES:
            key = f"{mode} @ {frac:g} R"
            res, futures, wall, delta, launches = open_loop(
                engine, requests, qps * frac, seed, **kw)
            served = check_served(futures, want, f"phase 7 [{key}]")
            if served != res.n_served or served == 0:
                raise AssertionError(f"phase 7 [{key}]: {served} served, "
                                     f"the run counted {res.n_served}")
            need = ["knrm_pool"] + (["csr_lookup"]
                                    if "cache_tiles" not in kw else [])
            for name in need:
                if launches[name] <= 0:
                    raise AssertionError(f"phase 7 [{key}]: {name} was not "
                                         "launched")
            if "cache_tiles" in kw and delta[
                    "seine_tile_cache_misses_total"] + delta[
                    "seine_tile_cache_hits_total"] <= 0:
                raise AssertionError(f"phase 7 [{key}]: the tile cache was "
                                     "not used")
            busy = device_busy(lambda: open_loop(engine, requests,
                                                 qps * frac, seed, **kw),
                               len(requests))
            wall_ms = wall * 1e3 / len(requests)
            st = res.stats
            slots = delta["seine_coalesce_pair_slots_total"]
            dedupe = (delta["seine_coalesce_distinct_pairs_total"] / slots
                      if slots else None)
            results[key] = dict(p50=st.p50_ms, p95=st.p95_ms,
                                queue_ms=st.queue_ms_per_request,
                                goodput=res.goodput, served=res.n_served,
                                rejected=res.n_rejected, dedupe=dedupe,
                                batches=delta["seine_frontend_batches_total"])
            log(f"phase 7 [{key}]: {res.n_submitted} requests at "
                f"{qps * frac:.1f}/s: served {res.n_served}, rejected "
                f"{res.n_rejected}, goodput {res.goodput:.4f}; p50 "
                f"{st.p50_ms:.3f} ms, p95 {st.p95_ms:.3f} ms, queue "
                f"{st.queue_ms_per_request:.3f} ms per request, queue depth "
                f"high water {st.max_queue_depth}; "
                f"{delta['seine_frontend_batches_total']:g} batches, dedupe "
                f"ratio {'n/a' if dedupe is None else f'{dedupe:.4f}'} "
                f"({delta['seine_coalesce_distinct_pairs_total']:g} "
                f"distinct of {slots:g} pair slots); tile cache hits "
                f"{delta['seine_tile_cache_hits_total']:g} misses "
                f"{delta['seine_tile_cache_misses_total']:g} evictions "
                f"{delta['seine_tile_cache_evictions_total']:g} overflow "
                f"pairs {delta['seine_tile_cache_overflow_pairs_total']:g};"
                f" launches {launches}; wall {wall:.3f}s, device busy "
                f"{busy['ms']:.4f} ms per request, "
                f"{busy_share(busy, wall_ms)}; all {served} served scores "
                f"== engine.score (bitwise)")
    # the epoch swap: the same partition packed, behind a cached front end
    packed = pack_index(pidx, "packed")
    p_engine = SeineEngine(packed, "knrm", engine.params, codec="packed")
    swaps = metric("seine_frontend_epoch_swaps_total")
    reqs = requests[:FE_SWAP_REQUESTS]
    with ServingFrontend(engine, max_batch=FE_MAX_BATCH,
                         batch_timeout_ms=FE_TIMEOUT_MS,
                         cache_tiles=FE_CACHE_TILES) as fe:
        check_served([fe.submit(q, d) for q, d in reqs],
                     want[:FE_SWAP_REQUESTS], "phase 7 [before the swap]")
        epoch = fe.cache.epoch
        fe.swap_engine(p_engine)
        futures = [fe.submit(q, d) for q, d in reqs]
        with torch.inference_mode():
            p_want = [p_engine.score(q, d).cpu().numpy() for q, d in reqs]
        n = check_served(futures, p_want, "phase 7 [after the swap]")
        if fe.cache.epoch != epoch + 1 or n != len(reqs):
            raise AssertionError(f"phase 7: after the swap the cache epoch "
                                 f"is {fe.cache.epoch} (was {epoch}), "
                                 f"{n} of {len(reqs)} served")
    if metric("seine_frontend_epoch_swaps_total") != swaps + 1:
        raise AssertionError("phase 7: the swap was not counted")
    same = all(np.array_equal(a, b) for a, b in
               zip(p_want, want[:FE_SWAP_REQUESTS]))
    log(f"phase 7: swap_engine to the packed copy: {len(reqs)} requests "
        f"after it == the packed engine's scores (bitwise; == the raw "
        f"scores too: {same}), cache epoch {epoch} -> {fe.cache.epoch}, "
        f"one swap counted")
    return results


# ---------------------------------------------------------------------------
# phase 6: the LM bridge
# ---------------------------------------------------------------------------

def lm_config():
    return get_lm_config(LM_ARCH)


def fa_build_shape(lm):
    """(B, S, Hq, Hkv, hd) of the attention in one build batch."""
    return (LM_BATCH, BUILD_MAX_LEN, lm.n_heads, lm.n_kv_heads, lm.head_dim)


def qkv(shape, dtype, gen, dev):
    b, s, hq, hkv, hd = shape
    return [torch.randn(n, s, h, hd, generator=gen, device=dev).to(dtype)
            for n, h in ((b, hq), (b, hkv), (b, hkv))]


def check_flash_attn(lm, seed, dev):
    """The kernel against its plain version on the card: the build's
    shape in bf16 (2e-2) and float32 (rtol 1e-4 / atol 1e-5), then the
    sweep FA_SWEEP in both types.  Returns the largest |diff| at the
    build's shape in bf16 and in float32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = fa_build_shape(lm)
    cases = [(shape, True, torch.bfloat16), (shape, True, torch.float32)]
    cases += [(c[:5], c[5], dt) for c in FA_SWEEP
              for dt in (torch.float32, torch.bfloat16)]
    errs = []
    for shp, causal, dt in cases:
        q, k, v = qkv(shp, dt, g, dev)
        got = flash_attn_kernel(q, k, v, causal=causal)
        want = flash_attn_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = BF16_TOL if dt == torch.bfloat16 else FA_F32_TOL
        torch.testing.assert_close(got.float(), want.float(), **tol)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attn gave non-finite values at "
                                 f"{shp}")
        errs.append((got.float() - want.float()).abs().max().item())
    log(f"phase 6: flash_attn == plain at the build shape {shape} causal: "
        f"bf16 max |diff| {errs[0]:.3g} (bar 2e-2), float32 {errs[1]:.3g} "
        f"(bar rtol 1e-4/atol 1e-5); over {len(FA_SWEEP)} sweep shapes in "
        f"both types, largest |diff| {max(errs[2:]):.3g}")
    return errs[0], errs[1]


def check_lm_wiring(provider, toks, segs, dev):
    """The forward's wiring: one build batch's ``contextualize`` through
    the kernel against the same provider with the plain attention, on
    the card, at 2e-2, with the weights cast to float32 (a second copy),
    where the two attentions agree to ~1e-6, so the bar sees the layout,
    head grouping and mask alone.  In the working bf16 one-ulp
    differences of the attention output grow through the layers; that
    comparison is printed (largest |diff|, share of values past 2e-2),
    and the kernel's bf16 parity is held at the build shape by
    ``check_flash_attn``."""
    tb = torch.from_numpy(toks[:LM_BATCH]).to(dev)
    sb = torch.from_numpy(segs[:LM_BATCH]).to(dev)

    def both(cfg, params):
        with torch.inference_mode():
            return [LMProvider(cfg, params, provider.embed_dim,
                               proj=provider._proj, device=dev,
                               attention=attention).contextualize(tb, sb)
                    for attention in (None, flash_attn_plain)]

    got, want = both(provider.cfg, provider.params)
    bf_err = (got - want).abs()
    bf_share = (bf_err > BF16_TOL["atol"]
                + BF16_TOL["rtol"] * want.abs()).float().mean().item()
    del got, want
    params32 = {k: ({n: t.float() for n, t in v.items()}
                    if isinstance(v, dict) else v.float())
                for k, v in provider.params.items()}
    got, want = both(dataclasses.replace(provider.cfg, dtype="float32"),
                     params32)
    del params32
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **BF16_TOL)
    err = (got - want).abs().max().item()
    log(f"phase 6: contextualize {tuple(tb.shape)} through flash_attn == "
        f"through the plain attention at 2e-2 in float32 (max |diff| "
        f"{err:.3g}, values up to {want.abs().max().item():.3g}); in bf16 "
        f"max |diff| {bf_err.max().item():.3g}, {bf_share:.4%} of the "
        f"values past 2e-2")
    return dict(f32=err, bf16=bf_err.max().item(), bf16_share=bf_share)


def kernel_split(run, n: int):
    """Device ms per batch of ``run`` (``n`` batches), CUPTI kernel time
    summed into GEMMs, flash_attn, seg_interact and the rest; and the
    rest's largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    split = dict(gemm=0.0, flash_attn=0.0, seg_interact=0.0, rest=0.0)
    rest = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0:
            continue
        key = e.key.lower()
        if "flash_attn" in key:
            split["flash_attn"] += us
        elif "seg_interact" in key:
            split["seg_interact"] += us
        elif any(g in key for g in GEMM_KERNELS):
            split["gemm"] += us
        else:
            split["rest"] += us
            rest[e.key[:60]] = us
    top = sorted(rest.items(), key=lambda kv: -kv[1])[:4]
    return ({k: v / 1e3 / n for k, v in split.items()},
            ", ".join(f"{k} {v / 1e3 / n:.2f} ms" for k, v in top))


def check_lm_on_the_fly(pidx, builder, toks, segs, dev):
    """Indexed == No-Index for every stored pair of the first build
    batch: ``make_qd_fn`` over its LM_BATCH docs in build order (the same
    LM batch as the build's) for the union of their terms, against the
    index's M, at atol 1e-5."""
    tb = toks[:LM_BATCH]
    union = np.unique(tb[tb >= 0]).astype(np.int32)
    q = torch.from_numpy(union).to(dev)
    docs = torch.arange(LM_BATCH, dtype=torch.int32, device=dev)
    qd_fn = builder.make_qd_fn()
    with torch.inference_mode():
        fly = qd_fn(q, torch.from_numpy(tb).to(dev),
                    torch.from_numpy(segs[:LM_BATCH]).to(dev))
        looked = pidx.qd_matrix(q, docs)
    torch.cuda.synchronize()
    present = torch.from_numpy(
        (union[None, :, None] == tb[:, None, :]).any(-1)).to(dev)
    stored = looked.flatten(2).ne(0).any(-1)
    if not bool((stored == present).all()):
        raise AssertionError("the stored pairs of the first build batch "
                             "are not its docs' terms")
    err = (looked - fly).abs().max().item()
    if err > 1e-5:
        raise AssertionError(f"indexed != on-the-fly: {err}")
    log(f"phase 6: indexed == on-the-fly for all {int(present.sum())} "
        f"stored pairs of the first build batch ({union.size} terms x "
        f"{LM_BATCH} docs; max |diff| {err:.3g}, bar 1e-5)")


def serve_lm(pidx, builder, toks, segs, ds, vocab, seed, dev):
    """The LM-built index served: a KNRM SeineEngine answers LM_REQUESTS
    requests over built docs, a NoIndexEngine over the same LM the first
    LM_NOINDEX_REQUESTS of them over LM_NOINDEX_CAND candidates; launch
    counts zeroed just before each path and read just after."""
    params = get_retriever("knrm").init(torch.Generator().manual_seed(seed),
                                        pidx.n_b, builder.functions,
                                        device=dev)
    engine = SeineEngine(pidx, "knrm", params)
    noindex = NoIndexEngine(builder, pidx, toks, segs, "knrm", params)
    queries = pad_queries(ds.queries, vocab.map_tokens, q_len=Q_SLOTS)
    crng = np.random.RandomState(seed)
    requests = [(queries[i], crng.choice(toks.shape[0], LM_CAND,
                                         replace=False).astype(np.int32))
                for i in range(LM_REQUESTS)]
    short = [(q, c[:LM_NOINDEX_CAND])
             for q, c in requests[:LM_NOINDEX_REQUESTS]]
    out, counts = {}, {}
    for path, eng, reqs, need in (
            ("indexed", engine, requests, ("csr_lookup", "knrm_pool")),
            ("noindex", noindex, short,
             ("flash_attn", "seg_interact", "knrm_pool"))):
        serve_batches(eng, reqs[:1])           # warm-up, uncounted
        for fn in COUNTERS.values():
            fn.launches = 0
        out[path] = serve_batches(eng, reqs)
        counts[path] = {n: fn.launches for n, fn in COUNTERS.items()}
        for name in need:
            if counts[path][name] <= 0:
                raise AssertionError(f"{name} was not launched serving the "
                                     f"LM-built index ({path})")
        st = out[path][1]
        log(f"phase 6 [{path}]: launches {counts[path]}; serve_batches "
            f"{len(reqs)} x ({Q_SLOTS} slots, {len(reqs[0][1])} "
            f"candidates): p50 {st.p50_ms:.3f} ms p95 {st.p95_ms:.3f} ms")
    err = 0.0
    for s, n in zip(out["indexed"][0], out["noindex"][0]):
        assert s.shape == (LM_CAND,) and np.isfinite(s).all()
        np.testing.assert_allclose(n, s[:LM_NOINDEX_CAND], **BF16_TOL)
        err = max(err, float(np.abs(n - s[:LM_NOINDEX_CAND]).max()))
    log(f"phase 6: No-Index scores == indexed scores at 2e-2 on "
        f"{LM_NOINDEX_REQUESTS} requests (largest |diff| {err:.3g})")
    return counts


def time_flash_attn(lm, launches, errs, dev):
    """flash_attn at the build's shape in bf16: the kernel (CUPTI), its
    plain version and ``F.scaled_dot_product_attention`` (the library
    yardstick, never used by the port; K and V repeated first when it
    lacks ``enable_gqa``).  The bound: q, k, v read once and o written
    once over 3.35 TB/s, or the causal flops (2 products x 2 hd per
    (query, key) pair at or below the diagonal) over 989 TFLOP/s."""
    shape = fa_build_shape(lm)
    b, s, hq, hkv, hd = shape
    q, k, v = qkv(shape, torch.bfloat16, torch.Generator(device=dev)
                  .manual_seed(1), dev)
    ms, how, call_ms = timed([lambda: flash_attn_kernel(q, k, v)], 50,
                             "flash_attn_kernel")
    plain_ms = events_ms([lambda: flash_attn_plain(q, k, v)], 5)
    qf, kf, vf = q.float(), k.float(), v.float()
    f32_ms = timed([lambda: flash_attn_kernel(qf, kf, vf)], 20,
                   "flash_attn_kernel")[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        lib = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    except TypeError:                        # no enable_gqa: repeat K, V
        kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kt, vt))
        lib = lambda: sdpa(qt, kr, vr, is_causal=True)
    library_ms = events_ms([lib], 50)
    n_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
    flops = 4.0 * b * hq * hd * (s * (s + 1) / 2)
    b_ms, b_by = bound(n_bytes, flops, BF16_FLOPS_PER_S)
    log(f"phase 6: flash_attn at {shape} causal bf16: {ms:.4f} ms ({how}; "
        f"{call_ms:.4f} ms with launch cost) = {flops / ms / 1e9:.2f} "
        f"TFLOP/s; float32 inputs {f32_ms:.4f} ms; plain {plain_ms:.4f} ms;"
        f" scaled_dot_product_attention {library_ms:.4f} ms; bound "
        f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.1f} GFLOP)")
    return dict(name="flash_attn", route="cuda",
                source=KERNEL_SOURCE.format("flash_attn", "flash_attn"),
                replaces=TPU_KERNELS["flash_attn"],
                launches=launches["build"], launches_by_path=launches,
                max_abs_err=errs[0], f32_max_abs_err=errs[1], ms=ms,
                timed_by=how, call_ms=call_ms, f32_ms=f32_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def phase6(seed: int, dev, corpus):
    """The LM bridge at minitron-4b's full width and depth (module doc),
    over phase 5's corpus."""
    cfg, ds, vocab, toks, segs, _ = corpus
    toks, segs = toks[:LM_DOCS], segs[:LM_DOCS]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    lm = lm_config()
    t0 = time.perf_counter()
    params = T.init_params(lm, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    provider = LMProvider(lm, params, cfg.embed_dim, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(seed + 7))
    table = provider.table()
    torch.cuda.synchronize()
    tensors = [t for v in params.values()
               for t in (v.values() if isinstance(v, dict) else [v])]
    n_params = sum(t.numel() for t in tensors)
    if n_params != lm.n_params:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{lm.n_params}")
    log(f"phase 6: {lm.name} ({lm.n_layers} layers, d_model {lm.d_model}, "
        f"{lm.n_heads}/{lm.n_kv_heads} heads of {lm.head_dim}, d_ff "
        f"{lm.d_ff}, vocab {lm.vocab_size}, {lm.dtype}): {n_params} "
        f"parameters, {sum(t.numel() * t.element_size() for t in tensors)}"
        f" bytes, drawn in {time.perf_counter() - t0:.2f}s; table() "
        f"{tuple(table.shape)} {table.dtype}")
    fa_errs = check_flash_attn(lm, seed, dev)
    wiring = check_lm_wiring(provider, toks, segs, dev)

    ip = init_interaction_params(torch.Generator().manual_seed(seed + 1),
                                 cfg.embed_dim, device=dev)
    builder = IndexBuilder(cfg, vocab, provider, ip=ip, device=dev)
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    pidx = builder.build_partitioned(toks, segs, LM_K, batch_size=LM_BATCH,
                                     max_uniq=BUILD_MAX_UNIQ)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    built = {n: fn.launches for n, fn in COUNTERS.items()}
    st = builder.last_build_stats
    log(f"phase 6: build launches {built}")
    if built["flash_attn"] != lm.n_layers * st.n_batches:
        raise AssertionError(f"flash_attn launched {built['flash_attn']} "
                             f"times for {lm.n_layers} layers x "
                             f"{st.n_batches} batches")
    if built["seg_interact"] != st.n_batches:
        raise AssertionError(f"seg_interact launched {built['seg_interact']}"
                             f" times for {st.n_batches} batches")
    stage = ", ".join(f"{k} {v:.2f}s" for k, v in st.stage_s.items())
    dev_s = ", ".join(f"{k} {v / 1e3:.2f}s"
                      for k, v in st.stage_device_ms.items())
    log(f"phase 6: build_partitioned K={pidx.n_shards}: {st.n_docs} docs in "
        f"{wall:.2f}s ({st.n_docs / wall:.1f} docs/s end to end; stages "
        f"1-3 {st.build_s:.2f}s = {st.docs_per_s:.1f} docs/s), "
        f"{st.n_batches} batches; host seconds per stage: {stage}; device "
        f"time per stage: {dev_s or 'not measured'}; nnz {pidx.nnz}, "
        f"posting_nbytes {pidx.posting_nbytes}")
    n_split = min(2, st.n_batches)
    split = kernel_split(lambda: builder.pipeline.stream_runs(
        toks[:n_split * LM_BATCH], segs[:n_split * LM_BATCH],
        batch_size=LM_BATCH, max_uniq=BUILD_MAX_UNIQ), n_split)
    if split is not None:
        parts, rest = split
        log(f"phase 6: device ms per build batch (CUPTI, {n_split} "
            f"batches): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      parts.items())
            + f"; total {sum(parts.values()):.2f}; largest of the rest: "
            f"{rest}")
    check_lm_on_the_fly(pidx, builder, toks, segs, dev)
    served = serve_lm(pidx, builder, toks, segs, ds, vocab, seed, dev)
    row = time_flash_attn(lm, {"build": built["flash_attn"],
                               "noindex": served["noindex"]["flash_attn"]},
                          fa_errs, dev)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    log(f"phase 6: peak device memory "
        f"{peak if peak is not None else 'not measured'} bytes")
    row["peak_bytes"] = peak
    row["contextualize_diff"] = wiring
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = build_all()
    log(f"phase 0: built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    index, rng = build_index(args.seed, dev)
    packed, _ = build_packed(index)
    p2 = phase2(index, rng, dev)
    phase2_packed(index, packed, p2)
    requests, queries, launches = phase3(index, packed, rng, dev, args.seed)
    kernels = phase4(index, packed, requests, queries, launches, p2, dev)
    del index, packed, p2
    torch.cuda.empty_cache()
    corpus = build_corpus(args.seed)
    rows, built = phase5(args.seed, dev, corpus)
    kernels += rows
    phase7(built, args.seed, dev)
    del built
    # the closed front ends' reference cycles still hold phase 5's
    # engine: collect them, so its index leaves the card before phase 6
    gc.collect()
    torch.cuda.empty_cache()
    kernels.append(phase6(args.seed, dev, corpus))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
