#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SEINE (query phase, offline build,
front end, live index, ranker training, LM bridge, MoE LM and decode,
SNRM, LM training, the recsys models and MACE, the launch tools) on one
NVIDIA GPU.

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
   {64, 256, 1024} (bitwise), and over the same pairs as the front end's
   coalesced lookup runs it, each pair routed on its own in a (1, P)
   grid; the first-stage scan as the main path runs
   it, one ``lane_bounds`` table per query and ``retrieve_windows`` over
   every doc block through it, the table, every block (== M assembled
   from the plain table) and the independent per-block scan all bitwise;
   ``knrm_pool`` (rtol 1e-5 / atol 1e-6; cos_norm in [-1, 1] and in
   [0.99, 1], where only the exact-match kernel counts, at n_b 20 and 7);
   and the committed K=4 hot-term-split fixture
   (``tests/data/torch_hot_term_k4``: per-pair routing, K > 1; bitwise,
   the (1, P) grid too; scans in blocks of 7, 16 and 64).  Then, for
   both codecs, the same for ``csr_lookup_packed`` (tiles
   {64, 256, 1024}) and ``lane_bounds_packed`` with
   ``retrieve_windows_packed`` (every doc block of a query), and both over
   the fixture packed on the card; all bitwise, the lookups also as a
   (1, P) grid routed per pair, ``packed`` also against the raw index's
   M.
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
   data-sheet peaks) for this run's data; ``knrm_pool``'s is the largest
   of those and its exponentials (one per live segment, row and kernel)
   and logarithms at the special-function rate (16 per clock per SM at
   compute capability 9.0, times the SMs and the highest SM clock the
   card reports).  ``csr_lookup`` is also timed at the front end's
   coalesced shape: 8 of the requests deduplicated by ``plan_coalesced``,
   a (1, P) grid routed per pair.  The scans are
   timed as whole scans of the 8 retrieval queries (a table, then 64
   blocks): a scan row's ``ms`` is all the device work of a block
   (CUPTI: the block kernel, 1/64 of the table, any memset), its
   ``library_ms`` the copy
   alone by PyTorch calls (``torch.zeros``, ``index_select`` and
   ``index_copy_`` of the found rows at given positions; no single call
   computes the whole function); a table row's ``ms`` is per launch (per
   query), beside ``torch.searchsorted`` of the same (term, doc) keys for
   the raw index.  The packed kernels are timed under both codecs
   (``packed`` in the row's own keys, ``packed-q8`` under ``q8``);
   ``csr_lookup`` and ``csr_lookup_packed`` warm (``ms``) and with a cold
   L2 (``ms_cold``: 64 MB overwritten before every launch) and at the
   coalesced shape (``coalesced``).

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
   plain version and its bound at the build batch and at the No-Index
   request's shape (the served requests' 1,000 candidates x 6 query
   slots), with its share of the No-Index p50.  ``embed_bag`` (the
   provider's and ``log_cond_prob``'s segment sums, through its segment
   entry: one launch that bags on the card) must launch twice per batch;
   both its entries are held bitwise against their plain versions on the
   build's own calls (captured by running 16 batches again), the CSR entry
   over tests/test_kernels.py's sweep with empty bags, -1 and past-table
   ids and the segment entry over SEGMENT_SWEEP, in float32 and bf16, and
   both are timed at both build shapes beside the sort-based bagging,
   ``F.embedding_bag`` and their bounds.

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

8. The live index over phase 5's K = 4 index (``dist/live.py``): docs
   0-4,095 ingested again as new ids in 4 chunks while the coalesced
   front end serves 256 LETOR requests at R / 2 (every served score
   equal to phase 7's ``engine.score`` bitwise, before, during and after
   the ingest; the docs ingested again equal their originals, M and
   scores); 64 tombstones (32 base, 32 inserted); ``compact(wait=False)``
   while a front end with the 4,096-tile cache serves 256 more at R / 2
   (scores equal the view's before it; M of 16 requests and top-1000 ids
   of 8 queries unchanged by the swap; no tombstoned doc in a top-k; its
   M rows zero; generation 1; the cache's epoch rises); the launches of
   the ingest (``seg_interact`` once, ``embed_bag`` twice per batch) and
   of the serving; each step's seconds, p50 / p95, queue ms and goodput
   during the ingest and the compaction beside phase 7's coalesced R / 2
   row, ``delta_nnz`` and the peak device memory. Then a live index of
   2,048 + 1,024 docs against ``build_partitioned`` of the 3,072 on the
   card (nnz, M, top-k bitwise); ``repro_torch.launch.serve.main()`` in
   process three times (the live open loop over a ``packed-q8`` base, the
   live first stage, the re-rank with ``--compare-noindex``), the
   launches of each counted and the snapshot's build, partition, live
   and heartbeat families checked; and ``seg_interact`` at n_seg 65, 128
   and 130 and ``knrm_pool`` at n_b 1,024, 1,025 and 2,500 against their
   plain versions, timed beside today's shapes. (Phase 8 runs after
   phase 7 and before phase 6.)

9. Ranker training over phase 5's K = 4 index (``launch/train.py``):
   KNRM trained by ``train_ranker`` for 200 steps of 16 pairs (the
   pairwise hinge of B = 1 scores, ``adam(3e-3)``, a ``PairSampler`` over
   all 200 queries whose position is set from the step) with checkpoints
   every 50 steps, keep 3; the launch counts are zeroed just before and
   read just after, and ``csr_lookup`` and ``knrm_pool`` must each rise
   by at least one per step.  The checkpoints after step 100 are deleted
   and ``fit`` resumes from 100 to 200: the final parameters must equal
   the uninterrupted run's (atol 1e-6).  The first step's M (bitwise),
   loss, grad norm and gradients through the kernels against the same
   through their plain versions on the card (rtol 1e-5 / atol 1e-6);
   DeepTileBars trained for 40 steps (``bench_table1.py``'s protocol);
   both losses must fall by tests/test_retrievers.py's bar (the last
   window's mean at most the first's + 0.05; 20 steps for KNRM, 8 for
   DeepTileBars).  P@5, P@10, MAP, nDCG@5 and nDCG@10 over the 200
   queries, each scoring all 65,323 docs through ``SeineEngine.score``,
   for BM25, KNRM at its init, trained KNRM and trained DeepTileBars.
   ``train_seine_ranker("knrm", 20)`` on the card against the CPU (loss
   and grad norm histories at rtol 1e-4 / atol 1e-5, TF32 off), and
   ``repro_torch.launch.train.main()`` in process (launches counted; its
   ``obs`` snapshot holds the ``seine_train_*`` and
   ``seine_ckpt_saves_total`` families).  Printed: ms per step p50 /
   p95, ms per (q, d) training pair, launches per step, the step loop's
   busy share, the checkpoints' write seconds and the phase's peak
   device memory.  (Phase 9 runs after phase 8 and before phase 6.)

Every busy share is printed with how many of the port's kernel
launches CUPTI recorded over the replay ("k of n").

6. The LM bridge: the same corpus embedded by minitron-4b
   (``configs/lm_archs.py``: 32 layers, d_model 3,072, 24 query heads
   over 8 KV heads, head_dim 128, d_ff 9,216, vocab 256,000, bf16) at its
   full published width and depth, with random weights drawn on the card
   from ``--seed`` at the reference init's scales, through
   ``LMProvider(embed_dim=128)``.  The ``flash_attn`` kernel against its
   plain version at the build's shape (32 docs x 512 positions, causal;
   bf16 at 2e-2 on three draws, float32 at rtol 1e-4 / atol 1e-5) and
   over the shapes of tests/test_kernels.py::TestFlashAttention, a
   non-causal one and S = 160 with a group of 3, and hd 128 at S = 200
   causal and full (bf16 runs the ``wgmma`` kernel); one build batch's
   ``contextualize`` through the kernel against the plain attention
   (2e-2, with the weights cast to float32, and in bf16 through the
   first 2 layers; the bf16 difference through all layers is printed).
   Then
   ``build_partitioned(K=4)`` over the first 1,024 docs (32 batches of
   32), counts zeroed just before and read just after: ``flash_attn``
   must launch n_layers x batches times and ``seg_interact`` once per
   batch.  The device time of a build batch is split into GEMMs,
   ``flash_attn``, ``seg_interact``, the MoE FFN's ranges (0 here) and
   the rest (CUPTI).  Indexed M
   equals No-Index M (``make_qd_fn`` over the first batch's docs in build
   order) for every stored pair at atol 1e-5; a KNRM ``SeineEngine``
   serves 8 requests of 6 slots x 256 built docs and a ``NoIndexEngine``
   over the same LM answers 2 of them over 32 candidates (scores at the
   bf16 bar, 2e-2).  Last ``flash_attn``'s timing at the build's shape
   against its plain version, ``F.scaled_dot_product_attention`` and its
   bound (bytes over 3.35 TB/s or causal flops over the bf16 989
   TFLOP/s), the same on float32 inputs (TF32 off; flops over the FP32
   67 TFLOP/s), and the phase's peak device memory.

10. The MoE LM and KV-cache decode, after phase 6's weights are freed:
   granite-moe-3b-a800m (``configs/lm_archs.py``: 32 layers, d_model
   1,536, 24 / 8 heads of 64, 40 experts top-8 of d_expert 512 at
   capacity factor 1.25, a float32 router, vocab 49,155, bf16) at its
   full width and depth, random weights drawn on the card from
   ``--seed``, its parameter count held to the config's.  ``flash_attn``
   against its plain version at the build's shape (32, 512, 24 / 8, 64)
   in bf16 and float32; the LM build of phase 5's first 1,024 docs
   through ``LMProvider`` (K = 4), counts zeroed just before and read
   just after (``flash_attn`` n_layers x batches, ``seg_interact`` once
   and ``embed_bag`` at least once per batch), the share of (token,
   slot) pairs the dispatch dropped per batch (all pairs and the docs'
   own tokens'), a batch's device time split as phase 6's, with the
   kernels launched in ``moe_ffn``'s profiler ranges (``moe.route``,
   ``moe.dispatch``, ``moe.combine``) counted apart; indexed == No-Index
   and serving as in phase 6.  Decode:
   8 prompts of 512 tokens through ``prefill_cache``, then 64 greedy
   ``decode_step``s (ms per step p50 / p95, tokens/s, cache bytes, the
   greedy agreement with the bf16 forward over the same tokens at a
   dropless capacity factor 5.0, as decode never drops, beside the
   forward's median top-1 - top-2 logit margin and the median largest
   |decode - forward|); the same at 4 layers in float32 and the
   dropless capacity factor, every step's
   logits equal to the forward's at its position (rtol 2e-2 / atol
   2e-2); ``combine_decode_stats`` over 4 slices of layer 0's cache ==
   ``gqa_attention``'s decode output (rtol 1e-5 / atol 1e-5).  Last
   ``flash_attn``'s timing at the build shape (the ``kernels`` line's
   ``flash_attn_hd64`` row) and the phase's peak device memory.

11. SNRM (``core/snrm.py``) with ``benchmarks/bench_snrm.py``'s recipe
   over phase 5's 65,323 docs and 200 queries: d_latent 128,
   ``adam(3e-3)``, 80 steps of 16 (q, pos, neg) triples; the first
   step's loss and gradients on the card against the CPU's (rtol 1e-4 /
   atol 1e-5); every doc encoded in chunks of 4,096; dot-latent
   retrieval of all docs per query; P@5 / P@10 / MAP and the latent
   density beside phase 9's rows.

12. LM training, after phases 6 and 10's weights are freed.  The
   ``flash_attn`` backward kernel (``flash_attn_bwd.cu``) against its
   plain version at stablelm-1.6b's training shape (16, 1,024, 32 / 32,
   64), granite-moe's (8, 1,024, 24 / 8, 64), minitron-4b's (4, 1,024,
   24 / 8, 128) and a tail length (1, 1,000, 8 / 2, 64) causal and full,
   from the forward kernel's o and lse: float32 at rtol 1e-4 / atol
   1e-5, bf16 with at most 0.1% of the values past 2e-2; two launches
   bitwise; the forward's o bitwise the same with and without its lse,
   the lse at the float32 bar.  Per shape its device ms (CUPTI, both of
   its kernels), the plain version's, the backward of
   ``F.scaled_dot_product_attention`` (the library yardstick) and the
   bound (10 hd flops per attended pair over the bf16 peak, or q, k, v,
   o, dO, lse in and dQ, dK, dV out over 3.35 TB/s); beside it the bf16
   design's own bound (20 hd flops a pair: S and dP in both kernels, dQ,
   dK and dV from two bf16 parts) and the TFLOP/s against each; the bf16
   kernel's distance from the plain mirror of its operand rounding
   (``flash_attn_bwd_plain(bf16_parts=True)``).  Then
   ``train_lm("stablelm-1.6b", smoke=False)``: the published config
   (24 layers, d_model 2,048, 32 / 32 heads of 64, d_ff 5,632, vocab
   100,352, bf16) at (16, 1,024), weights drawn on the card from
   ``--seed``, 8 steps of ``adamw(3e-4)`` with every layer under remat
   and 4 cross-entropy chunks; first one step's loss and gradient norm
   through the kernels against the plain forward and backward on the
   card (2e-2), then the run: loss per step, ms per step p50 / p95,
   tokens/s, model FLOPs utilisation (6 x matmul parameters x tokens +
   attention, over 989 TFLOP/s), launches per step (``flash_attn`` 2 per
   layer, forward and recompute; ``flash_attn_bwd`` 1), the busy share
   and peak device memory.  granite-moe-3b-a800m at full width and 4 of
   its 32 layers (cut for time), (8, 1,024): the first step against the
   plain attention (the MoE's backward, the float32 router's gradient,
   the aux loss), then 2 steps.  Last a bf16 checkpoint and resume of
   stablelm at full width and 2 layers: the resumed step's loss has the
   uninterrupted run's bits.

14. The launch tools (``repro_torch.launch``): ``launch.dryrun`` counts
   all 42 (arch, shape) cells on the meta device in LAUNCH_JOBS worker
   processes (the counting pass's seconds on a line of their own, then
   one roofline-table line a cell); the bf16 ``flash_attn`` over
   stablelm's whole ``prefill_32k`` shape (2^31 elements a tensor)
   against its plain version on the last batch row's last head;
   then, with the launch counts at 0, ``run_cell`` on the card of
   ``seine/index_build``, ``bert4rec/serve_p99``, ``mace/molecule``,
   ``stablelm-1.6b/prefill_32k`` and ``stablelm-1.6b/train_4k`` (the LM
   cells one step each, train_4k's 64 microbatches), each drawn from
   ``--seed``, with peak GB, step
   seconds, flops, eager bytes and the roofline bound, and
   ``seine/retrieve``'s step on phase 1's index (8 terms x 16,384
   docs), bitwise ``SeineEngine.score``'s; ``flash_attn``,
   ``flash_attn_bwd``, ``seg_interact``, ``embed_bag``, ``csr_lookup``
   and ``knrm_pool`` must each have launched, and their rows in the
   ``kernels`` line gain ``launches_by_path["launch"]``.
15. The serving half of the mesh paths on a 1 x 1 mesh over NCCL
   (``launch.mesh.make_host_mesh``): phase 1's index (kept on the host
   since phase 4) served through ``SeineEngine(mesh=)`` as a single CSR
   (``shard_index``), as its K = 4 partition and with
   ``partition="term"`` and the shard count left to the mesh; each
   answers phase 3's 16 requests bitwise as phase 3's mesh-less engine
   did, with ``csr_lookup``, ``knrm_pool`` and the collectives'
   counts at 0 just before and read just after (NCCL's kernels as the
   profiler records them), and the meshed and mesh-less p50 per request
   beside the card's name and power limit; ``build_partitioned(mesh=)``
   over the first MESH_BUILD_DOCS docs of phase 5's corpus, bitwise the
   mesh-less build; ``sp_decode_attention(mesh, "model")`` at phase
   10's decode-cache shape against the mesh-less merge (rtol 1e-5 /
   atol 1e-5); ``restore_checkpoint(shardings=)`` of phase 9's last
   KNRM checkpoint, every leaf bitwise the saved one.
16. The training half of the mesh paths on a 1 x 1 mesh over NCCL:
   ``launch.steps``' cells built with the mesh, their arguments placed
   as DTensors (``Cell.place``) and stepped: stablelm-1.6b at full
   width and phase 12's (16, 1,024), ``adamw(3e-4)``, remat, under
   ``fsdp`` and under ``tp2d``, granite-moe at 4 layers under ``fsdp``,
   DLRM ``train_batch`` (phase 13's table cut) and MACE ``molecule``
   and ``minibatch_lg`` (169,984 nodes, 168,960 edges) at full width on
   each rank's nodes and edges (``dist.collective``'s
   ``all_gather_rows``, ``reduce_scatter_rows`` and ``all_reduce_sum``
   must each have run), each step's loss, grad norm and next parameters
   and moments bitwise the mesh-less step's (MACE's force gradients
   included), with the ``flash_attn`` / ``flash_attn_bwd``
   launches of a step (48 / 24 for stablelm), the NCCL entries the
   profiler records, ms a step meshed and mesh-less, tokens/s and peak
   bytes beside the card's name and power limit; ``seine/retrieve``
   placed on phase 1's index (``shard_index``: the ``csr_lookup``
   kernel on the held rows, partial M summed by ``all_reduce``,
   ``knrm_pool``) bitwise the mesh-less step; a 2-layer stablelm's
   fsdp-placed state saved (rank 0 writes whole tensors) and restored
   onto the tp2d layout bitwise.  Then, the NCCL world ended, five
   cells are counted on a fake world of 512 ranks by ``launch.dryrun
   --mesh multi`` processes, one a cell, all at once: stablelm-1.6b
   ``train_4k`` under ``fsdp``, granite-moe ``train_4k``, DLRM
   ``train_batch`` at full Criteo width and MACE ``ogb_products`` and
   ``minibatch_lg``, each with its argument bytes, flops and collective
   bytes by op a device, ``t_collective`` and counting seconds.  The
   ``kernels`` rows of ``flash_attn``, ``flash_attn_bwd``,
   ``csr_lookup`` and ``knrm_pool`` gain these launches.

The second-to-last line of output is one JSON object with a ``kernels``
list; the last is ``{"ok": true, "device": {...}}``.  Nothing of JAX or
of the ``repro`` package is imported.
"""
import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.ckpt import (all_steps, latest_step,  # noqa: E402
                              load_index, save_index)
from repro_torch.configs import (SEINE_LETOR, get_bundle,  # noqa: E402
                                 get_lm_config)
from repro_torch.configs import smoke as configs_smoke  # noqa: E402
from repro_torch.core.build_pipeline import (  # noqa: E402
    make_unique_terms_fn)
from repro_torch.core.builder import IndexBuilder  # noqa: E402
from repro_torch.core.index import (POSTING_TILE,  # noqa: E402
                                    build_from_rows)
from repro_torch.core.interactions import (  # noqa: E402
    init_interaction_params, seg_interact_inputs)
from repro_torch.core.providers import (HashProvider,  # noqa: E402
                                        LMProvider)
from repro_torch.core import snrm  # noqa: E402
from repro_torch.core.segment import segment_corpus  # noqa: E402
from repro_torch.core.vocab import build_vocabulary  # noqa: E402
from repro_torch.data.batching import (PairSampler,  # noqa: E402
                                       candidates_for_query, pad_queries)
from repro_torch.data.metrics import (evaluate_ranking,  # noqa: E402
                                      mean_metrics)
from repro_torch.data.recsys_data import (ctr_batch,  # noqa: E402
                                          seqrec_batch)
from repro_torch.data.synth_corpus import generate  # noqa: E402
from repro_torch.data.synth_corpus import ZIPF_FUNCTIONS  # noqa: E402
from repro_torch.kernels import build_all  # noqa: E402
from repro_torch.dist import live as live_mod  # noqa: E402
from repro_torch.dist.live import LiveIndex  # noqa: E402
from repro_torch.dist.partition import pack_index  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch import dryrun as launch_dryrun  # noqa: E402
from repro_torch.launch import report as launch_report  # noqa: E402
from repro_torch.launch import steps as launch_steps  # noqa: E402
from repro_torch.ckpt import restore_checkpoint  # noqa: E402
from repro_torch.convert import index_to_device  # noqa: E402
from repro_torch.dist.collective import (  # noqa: E402
    all_gather_rows, all_gather_stack, all_reduce_sum, reduce_scatter_rows)
from repro_torch.dist.sharding import (  # noqa: E402
    P, partition_index, tree_shardings)
from repro_torch.dist.dtensor import local_value as whole  # noqa: E402
from repro_torch.dist.sp_decode import sp_decode_attention  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     release_world)
from repro_torch.dist.sp_decode import (  # noqa: E402
    combine_decode_stats, local_decode_stats)
from repro_torch.kernels.csr_lookup import (  # noqa: E402
    assemble_block_ref, block_cells_ref, csr_lookup_kernel,
    csr_lookup_packed_kernel, csr_lookup_packed_plain, csr_lookup_plain,
    lane_bounds_kernel, lane_bounds_packed_kernel, lane_bounds_packed_ref,
    lane_bounds_ref, lane_scales, retrieve_lanes, retrieve_windows_kernel,
    retrieve_windows_packed_kernel, route_pairs, route_terms,
    scan_block_packed_ref, scan_block_ref, scan_edges)
from repro_torch.kernels.csr_lookup.ops import _route_cells  # noqa: E402
from repro_torch.kernels.embed_bag import (  # noqa: E402
    bag_ptr_from_offsets, embed_bag_kernel, embed_bag_plain,
    embed_bag_segment_kernel, segment_bag_sums_plain, segment_bags)
from repro_torch.kernels.embed_bag import ops as embed_bag_ops  # noqa: E402
from repro_torch.kernels.csr_lookup.ref import (  # noqa: E402
    _lane_scale, _route)
from repro_torch.kernels.flash_attn import (  # noqa: E402
    flash_attention_plain, flash_attn_bwd_kernel, flash_attn_bwd_plain,
    flash_attn_kernel, flash_attn_plain)
from repro_torch.kernels.knrm_pool import (knrm_pool_kernel,  # noqa: E402
                                           knrm_pool_ref)
from repro_torch.kernels.seg_interact import (  # noqa: E402
    flatten_segments, seg_interact, seg_interact_kernel, seg_interact_plain)
from repro_torch.models import mace as MA  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import gqa_attention  # noqa: E402
from repro_torch.retrievers import get_retriever  # noqa: E402
from repro_torch.retrievers import knrm as knrm_retriever  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DeadlineExceeded, NoIndexEngine, SeineEngine, ServingFrontend,
    make_qmeta, run_open_loop, serve_batches, serve_retrieval)
from repro_torch.serving.coalesce import plan_coalesced  # noqa: E402
from repro_torch.train import (adam, adamw,  # noqa: E402
                               apply_updates, global_norm, make_train_step,
                               value_and_grad)
from repro_torch.tree import flatten_with_paths  # noqa: E402
from repro_torch.tree import leaves as tree_leaves  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

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
TF32_FLOPS_PER_S = 495e12    # H100 SXM, dense TF32 tensor cores
# float32-accurate products on the tensor cores as split TF32 (each
# operand in two TF32 parts, three TF32 products a float32 product: the
# float32 flash_attn kernels)
SPLIT_TF32_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
# special-function results (exp2, log2, rcp, ...) per clock per SM at
# compute capability 9.0: the CUDA C++ Programming Guide's table of
# arithmetic instruction throughput
SFU_PER_CLOCK_PER_SM = 16
# the front end's coalesced lookup: a batch of FE_MAX_BATCH requests,
# deduplicated by plan_coalesced with CoalescingScorer's default pair pad
COALESCE_PAIR_PAD = 256
KERNEL_SOURCE = "src/repro_torch/kernels/{}/csrc/{}.cu"
TPU_KERNELS = {
    "csr_lookup": "src/repro/kernels/csr_lookup/kernel.py:217",
    "retrieve_windows": "src/repro/kernels/csr_lookup/kernel.py:162",
    "knrm_pool": "src/repro/kernels/knrm_pool/kernel.py:34",
    "csr_lookup_packed": "src/repro/kernels/csr_lookup/kernel.py:359",
    "retrieve_windows_packed": "src/repro/kernels/csr_lookup/kernel.py:442",
    # the lane-bounds tables: the lane bisects that feed the scan's TPU
    # kernels, split into a launch of their own once per scan
    "lane_bounds": "src/repro/kernels/csr_lookup/kernel.py:162",
    "lane_bounds_packed": "src/repro/kernels/csr_lookup/kernel.py:442",
    "seg_interact": "src/repro/kernels/seg_interact/kernel.py:50",
    "flash_attn": "src/repro/kernels/flash_attn/kernel.py:63",
    "embed_bag": "src/repro/kernels/embed_bag/kernel.py:40",
    # no TPU kernel: the JAX package differentiates gqa_attention
    "flash_attn_bwd": "src/repro/models/layers.py:166",
}
# the launch counter of each kernel, and the kernels each serving path
# (codec) must launch
COUNTERS = {"csr_lookup": csr_lookup_kernel,
            "lane_bounds": lane_bounds_kernel,
            "retrieve_windows": retrieve_windows_kernel,
            "knrm_pool": knrm_pool_kernel,
            "csr_lookup_packed": csr_lookup_packed_kernel,
            "lane_bounds_packed": lane_bounds_packed_kernel,
            "retrieve_windows_packed": retrieve_windows_packed_kernel,
            "seg_interact": seg_interact_kernel,
            "flash_attn": flash_attn_kernel,
            "embed_bag": embed_bag_kernel,
            "flash_attn_bwd": flash_attn_bwd_kernel}
# a piece of each kernel's CUDA function name, as CUPTI records it
KERNEL_NAMES = {"csr_lookup": "csr_lookup_kernel",
                "lane_bounds": "lane_bounds_kernel",
                "retrieve_windows": "retrieve_block_kernel",
                "knrm_pool": "knrm_pool_kernel",
                "csr_lookup_packed": "csr_lookup_packed_kernel",
                "lane_bounds_packed": "lane_bounds_packed_kernel",
                "retrieve_windows_packed": "retrieve_block_packed_kernel",
                "seg_interact": "seg_interact_kernel",
                "flash_attn": "flash_attn_kernel",
                "embed_bag": "embed_bag_",
                "flash_attn_bwd": "flash_attn_bwd_"}
# CUDA kernels one counted launch runs (a backward call: dQ, then dK / dV)
KERNELS_PER_LAUNCH = {"flash_attn_bwd": 2}
PATH_KERNELS = {"none": ("csr_lookup", "lane_bounds", "retrieve_windows",
                         "knrm_pool"),
                "packed": ("csr_lookup_packed", "lane_bounds_packed",
                           "retrieve_windows_packed", "knrm_pool"),
                "packed-q8": ("csr_lookup_packed", "lane_bounds_packed",
                              "retrieve_windows_packed", "knrm_pool")}
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
# the segment entry's sweep at the provider mix's shape (docs of 512
# tokens, 64 bins, a 9,280 x 128 table): empty bins and -1 rows, every
# token in one bin (a 512-row bag), one token per bin, bins past both ends
SEGMENT_SWEEP = ("random", "one_bin", "one_per_bin", "out_of_range")
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
# check_lm_wiring's bf16 check: through the first LM_BF16_LAYERS layers
# at most LM_BF16_PAST of the values past BF16_TOL.  An attention that
# rounds p to bf16 before P . V reads ~0.4% there, the kernel < 0.01%
# (scripts/flash_attn_precision.py; PERF.md section 6).
LM_BF16_LAYERS = 2
LM_BF16_PAST = 1e-3
FA_F32_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_kernels.py's bar
# (B, S, Hq, Hkv, hd, causal): tests/test_kernels.py::TestFlashAttention's
# causal shapes and its non-causal one, S = 160 with a group of 3, the
# build's head width at an S that is no multiple of the 64-key tile, and
# BERT4Rec's training attention (phase 13's B4R_FA_SHAPE)
FA_SWEEP = ((2, 128, 4, 2, 32, True), (1, 256, 8, 8, 64, True),
            (2, 64, 4, 1, 16, True), (1, 96, 2, 2, 32, True),
            (1, 64, 4, 2, 32, False), (2, 160, 6, 2, 32, True),
            (2, 200, 6, 2, 128, True), (2, 200, 6, 2, 128, False),
            (256, 200, 2, 2, 32, False))
FA_SEEDS = 3       # draws of the build-shape bf16 check
BF16_FLOPS_PER_S = 989e12    # H100 SXM, dense bf16 tensor cores
GEMM_KERNELS = ("gemm", "xmma", "nvjet", "cutlass", "cublas", "splitk")
# the profiler ranges of models/transformer.py's moe_ffn
MOE_RANGES = ("moe.route", "moe.dispatch", "moe.combine")


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
    by ``csr_lookup_plain``) and == the ref lowering, bit for bit; then the
    same pairs as the front end's coalesced lookup looks them up: every
    (term, doc) pair routed on its own, a (1, P) grid."""
    ref = index.qd_matrix(q, docs, impl="ref")
    for tile in tiles:
        got = index.qd_matrix(q, docs, tile=tile)
        want = plain_lookup(index, q, docs, tile)
        torch.cuda.synchronize()
        assert_equal(got, want, f"{what} csr_lookup tile={tile}")
        assert_equal(got, ref, f"{what} csr_lookup vs ref tile={tile}")
    shape = (q.shape[0], docs.shape[0])
    terms = q[:, None].expand(shape).reshape(-1).contiguous()
    pair_docs = docs[None].expand(shape).reshape(-1).contiguous()
    got = index.lookup_pair_rows(terms, pair_docs)
    want = plain_pairs(index, terms, pair_docs)
    torch.cuda.synchronize()
    assert_equal(got, want, f"{what} csr_lookup (1, P) pair grid")
    assert_equal(got, ref.transpose(0, 1).reshape(got.shape),
                 f"{what} csr_lookup (1, P) pair grid vs ref")


def plain_pairs(index, terms, docs):
    """``csr_lookup_plain`` on the card over pairs ``terms (P,)`` x ``docs
    (P,)``, each routed on its own as ``ops.csr_lookup_pairs`` routes them
    for the kernel: (P, n_b, n_f)."""
    from repro_torch.core.index import POSTING_TILE, build_fences
    to, dids, vals, t2s, rlo, _ = stacked(index)
    split = getattr(index, "split_term", None)
    if split is None:
        k, lo, hi = route_terms(terms[None], to, t2s, rlo)
    else:
        k, lo, hi = route_pairs(terms[None], docs[None], to, t2s, rlo, split,
                                index.split_doc)
    i32 = lambda a: a.to(torch.int32).contiguous()  # noqa: E731
    return csr_lookup_plain(i32(k), i32(lo), i32(hi), docs, dids,
                            build_fences(dids, POSTING_TILE), vals,
                            tile=POSTING_TILE)[:, 0]


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
    """retrieve_windows through the scan's lane-bounds table, as the main
    path runs it (one table for every block of the query): the table ==
    its plain version, and every block == its plain version (M assembled
    from the plain table) and == the independent per-block scan
    (``scan_block_ref``), bit for bit.  Returns the largest |diff|."""
    to, dids, vals, t2s, rlo, rhi = stacked(index)
    lo, hi = retrieve_lanes(q, to, t2s, rlo, rhi, dids.shape[1])
    lo, hi = lo.contiguous(), hi.contiguous()
    n_blocks = -(-index.n_docs // block)
    bounds = lane_bounds_kernel(dids, lo, hi, 0, block, n_blocks)
    table = lane_bounds_ref(dids, lo, hi, scan_edges(
        0, n_blocks * block, device=dids.device))
    assert_equal(bounds.table, table, f"{what} lane_bounds")
    table_err = (bounds.table - table).abs().max().item()
    err = 0.0
    for blo in range(0, index.n_docs, block):
        got = retrieve_windows_kernel(dids, vals, lo, hi, blo, block,
                                      bounds=bounds)
        want = assemble_block_ref(vals, None, table, blo, block)
        assert_equal(got, want, f"{what} retrieve_windows blo={blo}")
        assert_equal(got, scan_block_ref(dids, vals, lo, hi, blo, block),
                     f"{what} retrieve_windows vs scan_block_ref blo={blo}")
        err = max(err, (got - want).abs().max().item())
    return err, table_err


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
        f"tiles 64/256/1024, and as a (1, {Q_SLOTS * N_CAND}) pair grid")

    # retrieve_windows over every doc block of one query (hot term in it)
    scan_err, table_err = check_scan(index, qt, 1024, "full index")
    log("phase 2: lane_bounds and retrieve_windows == plain (bitwise) "
        "over all blocks, through one table per scan")

    # knrm_pool at the serving shape, plus exact-match and empty segments;
    # then cos_norm in [0.99, 1.0], where only the exact-match kernel
    # (sigma 1e-3) is far from 0 and spans exp(0) to exp(-50), at n_b 20
    # and at n_b 7 (no multiple of 4: the kernel stages one float at a
    # time), with a B * Q that its 16-row tiles do not divide
    g = torch.Generator(device=dev).manual_seed(1)
    knrm_err = 0.0
    for n_cand, n_b, c_lo in ((N_CAND, N_B, -1.0), (N_CAND, N_B, 0.99),
                              (N_CAND - 3, 7, 0.99), (N_CAND - 3, 7, -1.0)):
        cos = (torch.rand((n_cand, Q_SLOTS, n_b), generator=g, device=dev)
               * (1.0 - c_lo) + c_lo)
        cos[0, 0] = 1.0
        cos[1, 0] = c_lo
        mask = (torch.rand((n_cand, n_b), generator=g, device=dev)
                > 0.2).float()
        mask[2] = 0.0
        got = knrm_pool_kernel(cos, mask)
        want = knrm_pool_ref(cos, mask)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        knrm_err = max(knrm_err, (got - want).abs().max().item())
    log(f"phase 2: knrm_pool == plain at rtol 1e-5/atol 1e-6, cos_norm in "
        f"[-1, 1] and [0.99, 1], n_b {N_B} and 7 (max |diff| "
        f"{knrm_err:.3g})")

    # the K=4 hot-term-split fixture: per-pair routing, K > 1
    fx = load_index(FIXTURE, device=dev)
    assert fx.split_term is not None and fx.n_shards == 4
    qf = torch.tensor([0, 1, 17, -1, fx.vocab_size + 3, 39, 3],
                      dtype=torch.int32, device=dev)
    df = torch.arange(-1, fx.n_docs + 2, dtype=torch.int32, device=dev)
    check_lookup(fx, qf, df, (4, 64, 256, 1024), "K=4 fixture")
    for block in (7, 16, 64):
        check_scan(fx, qf, block, "K=4 fixture")
    log("phase 2: K=4 sub-sharded fixture == plain (bitwise)")
    return dict(scan_err=scan_err, table_err=table_err, knrm_err=knrm_err,
                q=qt, docs=dt,
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


def plain_packed_pairs(pidx, terms, docs):
    """``csr_lookup_packed_plain`` on the card over pairs ``terms (P,)`` x
    ``docs (P,)``, each routed and scaled on its own as
    ``ops.csr_lookup_pairs`` routes them for the kernel: (P, n_b, n_f)."""
    k, lo, hi = _route(terms[None], docs[None], pidx.term_offsets,
                       pidx.term_to_shard, pidx.range_lo, pidx.split_term,
                       pidx.split_doc)
    scale = (None if pidx.value_scale is None else _lane_scale(
        pidx.value_scale, pidx.range_lo, k, terms[None]).contiguous())
    i32 = lambda a: a.to(torch.int32).contiguous()  # noqa: E731
    return csr_lookup_packed_plain(
        i32(k), i32(lo), i32(hi), docs, pidx._packed(), pidx.fences,
        pidx._serve_values, scale, tile=pidx.codec_tile)[:, 0]


def check_packed_lookup(pidx, q, docs, what, raw=None):
    """csr_lookup_packed kernel (through the index's lookup, the main
    path's call) == its plain version == the ref lowering, bit for bit;
    the same pairs as the coalesced front end looks them up, a (1, P)
    grid routed per pair, likewise; and == the raw index's M when ``raw``
    is given."""
    got = pidx.qd_matrix(q, docs)
    want = csr_lookup_packed_plain(*packed_args(pidx, q, docs),
                                   tile=pidx.codec_tile)
    torch.cuda.synchronize()
    assert_equal(got, want, f"{what} csr_lookup_packed")
    ref = pidx.qd_matrix(q, docs, impl="ref")
    assert_equal(got, ref, f"{what} csr_lookup_packed vs ref")
    shape = (q.shape[0], docs.shape[0])
    terms = q[:, None].expand(shape).reshape(-1).contiguous()
    pair_docs = docs[None].expand(shape).reshape(-1).contiguous()
    pairs = pidx.lookup_pair_rows(terms, pair_docs)
    assert_equal(pairs, plain_packed_pairs(pidx, terms, pair_docs),
                 f"{what} csr_lookup_packed (1, P) pair grid")
    assert_equal(pairs, ref.transpose(0, 1).reshape(pairs.shape),
                 f"{what} csr_lookup_packed (1, P) pair grid vs ref")
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
    """retrieve_windows_packed through the scan's lane-bounds table, as
    ``check_scan`` holds the raw scan: the table and every block == their
    plain versions and the per-block ``scan_block_packed_ref``, and ==
    the raw scan's blocks when ``raw`` is given."""
    lo, hi, scale = packed_lanes(pidx, q)
    args = (pidx._packed(), pidx.fences, pidx._serve_values)
    t = pidx.codec_tile
    n_blocks = -(-pidx.n_docs // block)
    bounds = lane_bounds_packed_kernel(*args, lo, hi, 0, block, n_blocks,
                                       tile=t)
    table = lane_bounds_packed_ref(
        pidx._packed(), pidx.fences, pidx.nmax, lo, hi,
        scan_edges(0, n_blocks * block, device=lo.device), tile=t)
    assert_equal(bounds.table, table, f"{what} lane_bounds_packed")
    if raw is not None:
        to, dids, vals, t2s, rlo, rhi = stacked(raw)
        r_lo, r_hi = retrieve_lanes(q, to, t2s, rlo, rhi, dids.shape[1])
        r_lo, r_hi = r_lo.contiguous(), r_hi.contiguous()
        r_bounds = lane_bounds_kernel(dids, r_lo, r_hi, 0, block, n_blocks)
    for blo in range(0, pidx.n_docs, block):
        got = retrieve_windows_packed_kernel(*args, scale, lo, hi, blo,
                                             block, tile=t, bounds=bounds)
        want = assemble_block_ref(pidx._serve_values, scale, table, blo,
                                  block)
        assert_equal(got, want, f"{what} retrieve_windows_packed blo={blo}")
        assert_equal(got, scan_block_packed_ref(*args, scale, lo, hi, blo,
                                                block, tile=t),
                     f"{what} retrieve_windows_packed vs "
                     f"scan_block_packed_ref blo={blo}")
        if raw is not None:
            assert_equal(got, retrieve_windows_kernel(
                dids, vals, r_lo, r_hi, blo, block, bounds=r_bounds),
                f"{what} packed scan vs raw blo={blo}")


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
        log(f"phase 2: lane_bounds_packed and retrieve_windows_packed "
            f"({codec}) == plain (bitwise) over all blocks"
            + (", == the raw scan" if raw is not None else ""))
        fx = pack_index(p2["fixture"], codec, tile=8)
        for tile in (8, 64, 256):
            fxt = fx if tile == 8 else pack_index(p2["fixture"], codec,
                                                  tile=tile)
            check_packed_lookup(fxt, p2["fixture_q"], p2["fixture_docs"],
                                f"K=4 fixture {codec} tile={tile}",
                                p2["fixture"] if codec == "packed" else None)
            for block in (7, 16, 64):
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
    launched = sum(fn.launches * KERNELS_PER_LAUNCH.get(n, 1)
                   for n, fn in COUNTERS.items())
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
    phase3.scores = scores          # phase 15 serves them again, meshed
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


def f32_bounds(n_bytes: float, flops: float) -> dict:
    """Both bounds of float32 attention work: ``bound_ms`` with the flops
    over split TF32's 165 TFLOP/s (the float32 kernels' rate at float32
    accuracy, the least time), ``fma_bound_ms`` over the CUDA cores'
    FP32 67 TFLOP/s; each the larger of that and the bytes."""
    split = bound(n_bytes, flops, SPLIT_TF32_FLOPS_PER_S)
    fma = bound(n_bytes, flops)
    return dict(bound_ms=split[0], bound_by=split[1], fma_bound_ms=fma[0],
                fma_bound_by=fma[1])


def bounds_text(b: dict) -> str:
    return (f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}, split TF32 "
            f"at 165 TFLOP/s; FMA bound {b['fma_bound_ms']:.5f} ms, "
            f"{b['fma_bound_by']})")


def ptxas_summary(report: str):
    """One line per kernel instance of an ``nvcc -Xptxas -v`` report:
    its name and template arguments, registers, spill bytes and any
    warning."""
    out, fn, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spills {m.group(1)} / {m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append(f"{demangled(fn)}: {m.group(1)} registers, {spill}")
            fn = None
        if "arning" in line:
            out.append(line.strip())
    return out


def demangled(name: str) -> str:
    """``name<args>`` from an Itanium-mangled kernel name (nested names
    of length-prefixed parts, then integer and bool template
    arguments); an unmangled name as it is."""
    if not name.startswith("_Z"):
        return name
    i = 3 if name.startswith("_ZN") else 2
    parts = []
    while i < len(name) and name[i].isdigit():
        j = i
        while name[j].isdigit():
            j += 1
        n = int(name[i:j])
        parts.append(name[j:j + n])
        i = j + n
    args = re.findall(r"L[ib](\d+)E", name[i:].split("Ev", 1)[0])
    base = parts[-1] if parts else name
    return f"{base}<{', '.join(args)}>" if args else base


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
                bound_by=b_by, library_ms=lib_ms, ms_cold=ms_cold,
                coalesced=time_coalesced(index, requests, dev))


def time_coalesced(index, requests, dev):
    """csr_lookup at the front end's coalesced shape: one batch of
    FE_MAX_BATCH requests, deduplicated by ``plan_coalesced``, every
    distinct pair routed on its own and looked up through
    ``index.lookup_pair_rows``, a (1, P) grid; held against its plain
    version."""
    row = N_B * len(ZIPF_FUNCTIONS)
    terms, docs, _, n_distinct = plan_coalesced(requests[:FE_MAX_BATCH],
                                                COALESCE_PAIR_PAD)
    terms = torch.from_numpy(terms).to(dev)
    docs = torch.from_numpy(docs).to(dev)
    ms, how, call_ms = timed([lambda: index.lookup_pair_rows(terms, docs)],
                             40, "csr_lookup_kernel")
    got = index.lookup_pair_rows(terms, docs)
    want = plain_pairs(index, terms, docs)
    assert_equal(got, want, "coalesced csr_lookup")
    found = int((got != 0).reshape(got.shape[0], -1).any(-1).sum())
    # bytes the data needs: per pair its routing, its doc and a probe per
    # bisect step of its term's range, the found rows and every row written
    lo_hi = index.term_offsets.long()
    w = terms.long().clamp(0, index.vocab_size - 1)
    n = torch.where(terms >= 0, lo_hi[w + 1] - lo_hi[w], 0)
    n_probes = int((torch.log2(n.double() + 1).ceil() + 1).sum())
    n_bytes = (terms.shape[0] * (12 + 4 + row * 4) + n_probes * 4
               + found * row * 4)
    b_ms, b_by = bound(n_bytes, 0)
    log(f"phase 4: csr_lookup coalesced: {FE_MAX_BATCH} requests -> "
        f"{n_distinct} distinct pairs, a (1, {terms.shape[0]}) grid: "
        f"{ms:.5f} ms ({how}; {call_ms:.4f} ms with launch and routing "
        f"cost), bound {b_ms:.5f} ms ({b_by}), == plain (bitwise)")
    return dict(ms=ms, timed_by=how, call_ms=call_ms, pairs=terms.shape[0],
                distinct=n_distinct, bound_ms=b_ms, bound_by=b_by)


def device_profile(fns, iters: int):
    """``{device op: (ms, count)}`` of every kernel, memcpy and memset
    CUPTI records over ``iters`` calls cycling through ``fns``, after a
    warm-up; None when it records none."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    out = {e.key: (e.self_device_time_total / 1e3, e.count)
           for e in prof.key_averages() if e.self_device_time_total > 0}
    return out or None


def all_device_ms(fns, iters: int) -> float:
    """Device ms per call of every op the calls launch (CUPTI), or the
    CUDA-event time per call when the profiler records none."""
    prof = device_profile(fns, iters)
    if prof is None:
        return events_ms(fns, iters)
    return sum(t for t, _ in prof.values()) / iters


def scan_times(scans, n_blocks: int, table: str, kernel: str):
    """Whole first-stage scans, one per entry of ``scans`` (its table
    launch, then ``n_blocks`` block launches): ``ms``, all the device work
    per block (the block kernel, its 1 / n_blocks share of the table and
    any other op in the window, such as a memset); ``kernel_ms`` per block
    launch and ``table_ms`` per table launch (CUPTI); ``call_ms`` per
    block with the host's launch cost (CUDA events)."""
    call = events_ms(scans, len(scans)) / n_blocks
    prof = device_profile(scans, len(scans)) or {}

    def per_launch(piece):
        hits = [v for k, v in prof.items() if piece in k]
        n = sum(c for _, c in hits)
        return sum(t for t, _ in hits), n
    kernel_sum, n_kernel = per_launch(kernel)
    table_sum, n_table = per_launch(table)
    if not (n_kernel and n_table):
        return dict(ms=call, kernel_ms=call, table_ms=call, call_ms=call,
                    timed_by="events")
    rest = sum(t for t, _ in prof.values()) - kernel_sum - table_sum
    memsets = sum(c for k, (_, c) in prof.items() if "memset" in k.lower())
    kernel_ms, table_ms = kernel_sum / n_kernel, table_sum / n_table
    # per launch, so that records CUPTI dropped do not count as zeros
    return dict(
        ms=kernel_ms + table_ms / n_blocks + rest / (len(scans) * n_blocks),
        kernel_ms=kernel_ms, table_ms=table_ms, call_ms=call,
        timed_by=(f"cupti, all device ops of {len(scans)} scans: "
                  f"{n_kernel} of {len(scans) * n_blocks} block and "
                  f"{n_table} of {len(scans)} table launches recorded, "
                  f"{memsets} memsets"))


def copy_yardstick(vals_flat, cells, pos, n_cells: int, scale=None):
    """M built by PyTorch calls given the found postings' cells and flat
    positions: ``torch.zeros``, ``index_select`` of the rows (times the
    lane scale for int8 values) and ``index_copy_`` into M."""
    m = torch.zeros((n_cells,) + tuple(vals_flat.shape[1:]),
                    dtype=torch.float32, device=vals_flat.device)
    rows = vals_flat.index_select(0, pos)
    if scale is not None:
        rows = rows.to(torch.float32) * scale[:, None, None]
    return m.index_copy_(0, cells, rows)


def yardstick_ms(vals, tables, n_blocks: int, scales, check):
    """The copy yardstick's device ms per block over every block of the
    scans whose plain tables are ``tables``; ``check`` (blo, M) holds its
    first block against the kernel's M."""
    flat = vals.reshape((-1,) + tuple(vals.shape[2:]))
    q_n = tables[0].shape[0]
    calls = []
    for table, scale in zip(tables, scales):
        for b in range(n_blocks):
            cell, pos, lane = block_cells_ref(table, b * 1024, 1024)
            sc = None if scale is None else scale.reshape(-1)[lane]
            calls.append(lambda c=cell, p=pos, s=sc: copy_yardstick(
                flat, c, p, 1024 * q_n, s))
    check(0, calls[0]().view((1024, q_n) + tuple(vals.shape[2:])))
    return all_device_ms(calls, len(calls))


def time_scan(index, queries, errs, dev):
    """retrieve_windows as the main path runs it: per retrieval query one
    lane-bounds table (``lane_bounds``), then one launch per 1024-doc
    block over the whole corpus.  Returns the scan's row (``ms``: all the
    device work of a block) and the table's (ms per launch, once per
    query)."""
    row = N_B * len(ZIPF_FUNCTIONS)
    to, dids, vals, t2s, rlo, rhi = stacked(index)
    n_blocks = -(-N_DOCS // 1024)
    lanes, n_post = [], 0
    for q in queries:
        lo, hi = retrieve_lanes(torch.from_numpy(q).to(dev), to, t2s, rlo,
                                rhi, dids.shape[1])
        lanes.append((lo.contiguous(), hi.contiguous()))
        n_post += int((hi - lo).sum())

    def scan(lo, hi):
        bounds = lane_bounds_kernel(dids, lo, hi, 0, 1024, n_blocks)
        for b in range(n_blocks):
            retrieve_windows_kernel(dids, vals, lo, hi, b * 1024, 1024,
                                    bounds=bounds)
    t = scan_times([lambda c=c: scan(*c) for c in lanes], n_blocks,
                   "lane_bounds_kernel", "retrieve_block_kernel")
    edges = scan_edges(0, n_blocks * 1024, device=dev)
    tables = [lane_bounds_ref(dids, lo, hi, edges) for lo, hi in lanes]

    def plain_scan(lo, hi):
        table = lane_bounds_ref(dids, lo, hi, edges)
        for b in range(n_blocks):
            assemble_block_ref(vals, None, table, b * 1024, 1024)
    plain_ms = events_ms([lambda c=c: plain_scan(*c) for c in lanes[:2]],
                         2) / n_blocks
    plain_table_ms = events_ms([lambda c=c: lane_bounds_ref(dids, *c, edges)
                                for c in lanes], len(lanes))

    def check(blo, m):
        assert_equal(m, retrieve_windows_kernel(dids, vals, *lanes[0], blo,
                                                1024), "copy yardstick")
    lib_ms = yardstick_ms(vals, tables, n_blocks, [None] * len(tables),
                          check)
    # yardstick of the table: one searchsorted of every (term, edge) key
    # over the globally sorted (term, doc) keys (K == 1)
    counts = (index.term_offsets[1:] - index.term_offsets[:-1]).long()
    keys = torch.repeat_interleave(
        torch.arange(VOCAB, device=dev, dtype=torch.int64),
        counts) * (N_DOCS + 1) + index.doc_ids.long()
    probes = [torch.from_numpy(q).to(dev).long().clamp(min=0)[:, None]
              * (N_DOCS + 1) + edges[None] for q in queries]
    table_lib_ms = all_device_ms([lambda p=p: torch.searchsorted(keys, p)
                                  for p in probes], len(probes))
    # per block: its postings read (row + id) and M written; per table:
    # every lane's ids read once and the table written
    n_lanes = Q_SLOTS
    b_ms, b_by = bound(n_post * (row * 4 + 4) / (len(queries) * n_blocks)
                       + 1024 * Q_SLOTS * row * 4 + Q_SLOTS * 8, 0)
    tb_ms, tb_by = bound(n_post * 4 / len(queries) + n_lanes * 8
                         + n_lanes * edges.shape[0] * 4, 0)
    scan_row = dict(name="retrieve_windows", ms=t["ms"],
                    kernel_ms=t["kernel_ms"], timed_by=t["timed_by"],
                    call_ms=t["call_ms"], plain_ms=plain_ms,
                    max_abs_err=errs["scan_err"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms,
                    library="torch.zeros + index_select + index_copy_ of "
                    "the found rows at given positions (the copy alone; "
                    "no single call computes the whole function)")
    table_row = dict(name="lane_bounds", ms=t["table_ms"],
                     timed_by=t["timed_by"], call_ms=t["call_ms"],
                     plain_ms=plain_table_ms, max_abs_err=errs["table_err"],
                     bound_ms=tb_ms, bound_by=tb_by, library_ms=table_lib_ms,
                     library="torch.searchsorted of every (term, edge) key "
                     "over the sorted (term, doc) keys")
    return scan_row, table_row


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
    # a masked segment adds +0 to every sum and needs no work: this run's
    # data needs the (row, segment) pairs whose segment is live
    live = Q_SLOTS * int(mask.sum().item())
    # three limits: the bytes; per live (row, segment, kernel) a sub, two
    # mul and an fma at the fp32 rate; the exponential per live (row,
    # segment, kernel) and the logarithm per sum on the special-function
    # units
    limits = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
              "fma": (live * k * 4 + rows * k) / FP32_FLOPS_PER_S * 1e3,
              "sfu": (live * k + rows * k) / sfu_per_s() * 1e3}
    by = max(limits, key=limits.get)
    log("phase 4: knrm_pool limits (ms): " + ", ".join(
        f"{n} {v:.5f}" for n, v in limits.items()))
    return dict(name="knrm_pool", ms=ms, timed_by=how, call_ms=call_ms,
                plain_ms=plain_ms, max_abs_err=max(err, knrm_err),
                bound_ms=limits[by],
                bound_by="bytes" if by == "bytes" else "operations",
                bound_limits=limits, live_row_segments=live,
                library_ms=None)


def sfu_per_s() -> float:
    """The card's special-function results per second: SFU_PER_CLOCK_PER_SM
    x its SMs x the highest SM clock it reports."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_CLOCK_PER_SM * sms * float(mhz) * 1e6


def packed_probes(t_lo: int, t_hi: int) -> int:
    """The 4-byte loads a packed lookup cell over the range [t_lo, t_hi)
    needs: a fence bisect over the term's own tiles, the tile's (bits,
    base, word offset), the in-tile bisect and the hit check."""
    n_tiles = (max((t_hi - 1) // PACK_TILE, t_lo // PACK_TILE)
               - t_lo // PACK_TILE + 1)
    return (n_tiles.bit_length() + 3
            + min(PACK_TILE, t_hi - t_lo).bit_length() + 1)


def time_packed_lookup(pidx, requests, dev):
    """csr_lookup_packed at the serving shape over one codec's index,
    one input set per request, as :func:`time_lookup`: warm, and with a
    cold L2; then at the front end's coalesced shape."""
    row = N_B * len(ZIPF_FUNCTIONS)
    val_bytes = pidx._serve_values.element_size()
    inputs = [packed_args(pidx, torch.from_numpy(q).to(dev),
                          torch.from_numpy(d).to(dev)) for q, d in requests]
    fns = [lambda a=a: csr_lookup_packed_kernel(*a, tile=PACK_TILE)
           for a in inputs]
    ms, how, call_ms = timed(fns, 160, "csr_lookup_packed_kernel")
    # cold L2: the 16 requests' int8 rows (17 MB) would stay in the 50 MB
    # L2 across the timing loop, which a stream of fresh requests does not
    ms_cold = timed(fns, 160, "csr_lookup_packed_kernel", cold=True)[0]
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
    # bytes the data needs: each cell's probes (:func:`packed_probes`),
    # the found rows at their storage width, every f32 row written, the
    # candidates, the routing and the scales
    n_probes = sum(N_CAND * packed_probes(t_lo, t_hi)
                   for _, _, lo, hi, *_ in inputs
                   for t_lo, t_hi in zip(lo.tolist(), hi.tolist()))
    cells = N_CAND * Q_SLOTS
    n_bytes = ((n_probes * 4 + found * row * val_bytes) / len(inputs)
               + cells * row * 4 + N_CAND * 4 + Q_SLOTS * 16)
    b_ms, b_by = bound(n_bytes, 0)
    return dict(ms=ms, timed_by=how, call_ms=call_ms, plain_ms=plain_ms,
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                ms_cold=ms_cold,
                coalesced=time_packed_coalesced(pidx, requests, dev))


def time_packed_coalesced(pidx, requests, dev):
    """csr_lookup_packed at the front end's coalesced shape over one
    codec's index, as :func:`time_coalesced`: the distinct pairs of one
    batch, each routed on its own, a (1, P) grid through
    ``index.lookup_pair_rows``; held against the plain version."""
    row = N_B * len(ZIPF_FUNCTIONS)
    terms, docs, _, n_distinct = plan_coalesced(requests[:FE_MAX_BATCH],
                                                COALESCE_PAIR_PAD)
    terms = torch.from_numpy(terms).to(dev)
    docs = torch.from_numpy(docs).to(dev)
    ms, how, call_ms = timed([lambda: pidx.lookup_pair_rows(terms, docs)],
                             40, "csr_lookup_packed_kernel")
    got = pidx.lookup_pair_rows(terms, docs)
    assert_equal(got, plain_packed_pairs(pidx, terms, docs),
                 "coalesced csr_lookup_packed")
    found = int((got != 0).reshape(got.shape[0], -1).any(-1).sum())
    # bytes the data needs, as the serving shape counts them per pair
    _, lo, hi = _route(terms[None], docs[None], pidx.term_offsets,
                       pidx.term_to_shard, pidx.range_lo, pidx.split_term,
                       pidx.split_doc)
    n_probes = sum(packed_probes(t_lo, t_hi) for t_lo, t_hi in
                   zip(lo.reshape(-1).tolist(), hi.reshape(-1).tolist()))
    n_bytes = (terms.shape[0] * (16 + 4 + row * 4) + n_probes * 4
               + found * row * pidx._serve_values.element_size())
    b_ms, b_by = bound(n_bytes, 0)
    log(f"phase 4: csr_lookup_packed coalesced ({pidx.codec}): "
        f"{FE_MAX_BATCH} requests -> {n_distinct} distinct pairs, a (1, "
        f"{terms.shape[0]}) grid: {ms:.5f} ms ({how}; {call_ms:.4f} ms with "
        f"launch and routing cost), bound {b_ms:.5f} ms ({b_by}), == plain "
        f"(bitwise)")
    return dict(ms=ms, timed_by=how, call_ms=call_ms, pairs=terms.shape[0],
                distinct=n_distinct, bound_ms=b_ms, bound_by=b_by)


def time_packed_scan(pidx, queries, dev):
    """retrieve_windows_packed as the main path runs it, on one codec's
    index: per retrieval query one lane-bounds table
    (``lane_bounds_packed``), then one launch per 1024-doc block.  Every
    query's table and every 16th block are also held against their plain
    versions.  Returns the scan's measurements and the table's (``table``
    key)."""
    row = N_B * len(ZIPF_FUNCTIONS)
    val_bytes = pidx._serve_values.element_size()
    args = (pidx._packed(), pidx.fences, pidx._serve_values)
    bits = pidx.tile_bits.long()
    n_blocks = -(-N_DOCS // 1024)
    lanes, n_post, id_bits, n_tiles = [], 0, 0, 0
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
        lanes.append((scale, lo, hi))

    def scan(scale, lo, hi):
        bounds = lane_bounds_packed_kernel(*args, lo, hi, 0, 1024, n_blocks,
                                           tile=PACK_TILE)
        for b in range(n_blocks):
            retrieve_windows_packed_kernel(*args, scale, lo, hi, b * 1024,
                                           1024, tile=PACK_TILE,
                                           bounds=bounds)
    t = scan_times([lambda c=c: scan(*c) for c in lanes], n_blocks,
                   "lane_bounds_packed_kernel", "retrieve_block_packed_kernel")

    edges = scan_edges(0, n_blocks * 1024, device=dev)

    def plain_table(lo, hi):
        return lane_bounds_packed_ref(pidx._packed(), pidx.fences, pidx.nmax,
                                      lo, hi, edges, tile=PACK_TILE)
    tables = [plain_table(lo, hi) for _, lo, hi in lanes]

    def plain_scan(scale, lo, hi):
        table = plain_table(lo, hi)
        for b in range(n_blocks):
            assemble_block_ref(pidx._serve_values, scale, table, b * 1024,
                               1024)
    plain_ms = events_ms([lambda c=c: plain_scan(*c) for c in lanes[:2]],
                         2) / n_blocks
    plain_table_ms = events_ms([lambda c=c: plain_table(*c[1:])
                                for c in lanes], len(lanes))
    err = table_err = 0.0
    for (scale, lo, hi), table in zip(lanes, tables):
        bounds = lane_bounds_packed_kernel(*args, lo, hi, 0, 1024, n_blocks,
                                           tile=PACK_TILE)
        assert_equal(bounds.table, table, "lane_bounds_packed")
        table_err = max(table_err,
                        (bounds.table - table).abs().max().item())
        for b in range(0, n_blocks, 16):
            got = retrieve_windows_packed_kernel(
                *args, scale, lo, hi, b * 1024, 1024, tile=PACK_TILE,
                bounds=bounds)
            want = assemble_block_ref(pidx._serve_values, scale, table,
                                      b * 1024, 1024)
            assert_equal(got, want, f"retrieve_windows_packed blo={b * 1024}")
            err = max(err, (got - want).abs().max().item())

    def check(blo, m):
        scale, lo, hi = lanes[0]
        assert_equal(m, retrieve_windows_packed_kernel(
            *args, scale, lo, hi, blo, 1024, tile=PACK_TILE),
            "copy yardstick")
    lib_ms = yardstick_ms(pidx._serve_values, tables, n_blocks,
                          [c[0] for c in lanes], check)
    # per block: its postings (packed id bits, the touched tiles' 12 bytes
    # of metadata, the rows at their storage width) read and M written,
    # plus the lanes and their scales; per table: every lane's packed ids
    # and tile metadata read once and the table written
    n_lanes = Q_SLOTS * pidx.n_shards
    n_bytes = ((id_bits / 8 + n_tiles * 12 + n_post * row * val_bytes)
               / (len(queries) * n_blocks) + 1024 * Q_SLOTS * row * 4
               + n_lanes * 12)
    b_ms, b_by = bound(n_bytes, 0)
    tb_ms, tb_by = bound((id_bits / 8 + n_tiles * 12) / len(queries)
                         + n_lanes * 8 + n_lanes * edges.shape[0] * 4, 0)
    return dict(ms=t["ms"], kernel_ms=t["kernel_ms"], timed_by=t["timed_by"],
                call_ms=t["call_ms"], plain_ms=plain_ms, max_abs_err=err,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                table=dict(ms=t["table_ms"], timed_by=t["timed_by"],
                           call_ms=t["call_ms"], plain_ms=plain_table_ms,
                           max_abs_err=table_err, bound_ms=tb_ms,
                           bound_by=tb_by, library_ms=None))


def phase4(index, packed, requests, queries, launches, p2, dev):
    scan_row, table_row = time_scan(index, queries, p2, dev)
    rows = [dict(time_lookup(index, requests, dev), path="none"),
            dict(table_row, path="none"), dict(scan_row, path="none"),
            dict(time_knrm(index, requests, p2["knrm_err"], dev),
                 path="none")]
    lookup = {c: time_packed_lookup(packed[c], requests, dev) for c in CODECS}
    rows.append(dict(lookup["packed"], name="csr_lookup_packed",
                     path="packed", library_ms=None, q8=lookup["packed-q8"]))
    scan = {c: time_packed_scan(packed[c], queries, dev) for c in CODECS}
    table = {c: scan[c].pop("table") for c in CODECS}
    rows.append(dict(table["packed"], name="lane_bounds_packed",
                     path="packed", q8=table["packed-q8"]))
    rows.append(dict(scan["packed"], name="retrieve_windows_packed",
                     path="packed", q8=scan["packed-q8"]))
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
            kernel = ("" if m.get("kernel_ms") is None else
                      f", the block kernel alone {m['kernel_ms']:.5f} ms")
            cold = ("" if m.get("ms_cold") is None else
                    f", cold L2 {m['ms_cold']:.5f} ms")
            log(f"phase 4: {r['name']}{tag}: {m['ms']:.5f} ms "
                f"({m['timed_by']}; {m['call_ms']:.4f} ms with launch "
                f"cost{kernel}{cold}), plain {m['plain_ms']:.4f} ms, bound "
                f"{m['bound_ms']:.5f} ms ({m['bound_by']}), library "
                f"{m.get('library_ms', r['library_ms'])}")
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
    return counts, requests[:NOINDEX_REQUESTS], out["noindex"][1].p50_ms


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


def seg_work(inputs, n_b: int):
    """(flops, bytes) per launch that the function needs for these
    inputs, once each: the embedding rows of valid terms (id >= 0) and of
    kept tokens (segment in [0, S)), the whole seg and term-id arrays and
    the whole output; and 2 * U_b * L_b * De flops per doc for its valid
    terms and kept tokens."""
    flops = n_bytes = 0.0
    for e_term, e_tok, seg, term_ids in inputs:
        u = (term_ids >= 0).sum(1).double()
        length = ((seg >= 0) & (seg < n_b)).sum(1).double()
        de = e_term.shape[2]
        flops += 2 * float((u * length).sum()) * de
        n_bytes += float(u.sum() + length.sum()) * de * e_term.element_size()
        n_bytes += seg.numel() * 4 + term_ids.numel() * 4
        n_bytes += e_term.shape[0] * e_term.shape[1] * n_b * 3 * 4
    return flops / len(inputs), n_bytes / len(inputs)


def noindex_inputs(builder, toks, segs, requests, dev):
    """For each No-Index request, a function that makes the seg_interact
    kernel's arguments as ``NoIndexEngine.qd_matrix`` makes them (the
    candidates' real docs gathered on the card against the query's
    slots), and its result."""
    tok_d = torch.from_numpy(toks).to(dev)
    seg_d = torch.from_numpy(segs).to(dev)
    makers = []
    for q, cand in requests:
        c = torch.from_numpy(np.asarray(cand, np.int64)).to(dev)
        qt = torch.from_numpy(np.asarray(q, np.int32)).to(dev)
        makers.append(lambda c=c, qt=qt: seg_interact_inputs(
            tok_d[c], seg_d[c], qt[None].expand(c.numel(), -1),
            builder.provider.table(), builder.cfg.n_segments))
    return makers, [make() for make in makers]


def time_seg_interact(builder, toks, segs, launches, err, dev, requests,
                      noindex_p50_ms, **extra):
    """seg_interact at the build shape over 16 batches of fresh docs and
    at the No-Index request's shape over the served requests, its plain
    version at both, and torch.bmm of the build's score product alone
    (context, not a yardstick: it skips the epilogues).  The bounds count
    what this run's data needs (``seg_work``)."""
    n_b = builder.cfg.n_segments
    n_batches = max(1, min(16, toks.shape[0] // BUILD_BATCH))
    inputs = [batch_inputs(builder, toks, segs, i * BUILD_BATCH, dev)
              for i in range(n_batches)]
    flops, n_bytes = seg_work(inputs, n_b)
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
    b_ms, b_by = bound(n_bytes, flops)
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
        f"{flops / ms / 1e9:.2f} TFLOP/s on the valid "
        f"(term, token) pairs; plain {plain_ms:.4f} ms; bound "
        f"{b_ms:.5f} ms ({b_by}: {flops / 1e9:.4f} GFLOP, "
        f"{n_bytes / 1e6:.2f} MB); torch.bmm of the scores alone "
        f"{bmm_ms:.4f} ms; the same batch with all {a[0].shape[1]} term "
        f"slots and {n_l} tokens live {live_ms:.4f} ms = "
        f"{live_flops / live_ms / 1e9:.2f} TFLOP/s")
    # the No-Index request's shape: the served requests' candidates
    makers, q_inputs = noindex_inputs(builder, toks, segs, requests, dev)
    q_flops, q_bytes = seg_work(q_inputs, n_b)
    inputs_ms = events_ms(makers, 2 * len(makers))
    q_ms, q_how, q_call_ms = timed(
        [lambda a=a: seg_interact_kernel(*a, n_b) for a in q_inputs], 80,
        "seg_interact_kernel")
    q_plain_ms = events_ms([lambda a=a: seg_interact_plain(*a, n_b)
                            for a in q_inputs], len(q_inputs))
    for a in q_inputs:
        got, want = seg_interact_kernel(*a, n_b), seg_interact_plain(*a, n_b)
        torch.testing.assert_close(got, want, **SEG_TOL)
        err = max(err, (got - want).abs().max().item())
    q_b_ms, q_b_by = bound(q_bytes, q_flops)
    share = q_ms / noindex_p50_ms
    log(f"phase 5: seg_interact at the No-Index request's shape "
        f"{tuple(q_inputs[0][0].shape)} x {tuple(q_inputs[0][1].shape[1:])}"
        f" over {len(q_inputs)} requests: {q_ms:.4f} ms per request "
        f"({q_how}; {q_call_ms:.4f} ms with launch cost); plain "
        f"{q_plain_ms:.4f} ms; bound {q_b_ms:.5f} ms ({q_b_by}: "
        f"{q_flops / 1e9:.4f} GFLOP, {q_bytes / 1e6:.2f} MB); "
        f"{share:.4f} of the No-Index p50 ({noindex_p50_ms:.3f} ms); "
        f"making its dense inputs (seg_interact_inputs' gathers) "
        f"{inputs_ms:.4f} ms")
    return dict(name="seg_interact", ms=ms, timed_by=how, call_ms=call_ms,
                plain_ms=plain_ms, max_abs_err=err, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, route="cuda",
                source=KERNEL_SOURCE.format("seg_interact", "seg_interact"),
                replaces=TPU_KERNELS["seg_interact"],
                launches=launches["build"],
                launches_by_path=launches, bmm_ms=bmm_ms,
                all_live_ms=live_ms, noindex_ms=q_ms,
                noindex_timed_by=q_how, noindex_call_ms=q_call_ms,
                noindex_plain_ms=q_plain_ms, noindex_bound_ms=q_b_ms,
                noindex_bound_by=q_b_by, noindex_share=share,
                noindex_inputs_ms=inputs_ms, **extra)


def build_embed_bag_calls(builder, toks, segs, n_docs: int):
    """The segment entry's arguments ``(table, rows, bins, n_bins)`` in
    the build's own calls over the first ``n_docs`` docs: stages 1-3 run
    once more with the wrapper recording them (and still launching).
    Returns ``(mix, lcp)``: the provider mix's calls and
    log_cond_prob's, in batch order."""
    calls = []
    wrapped = embed_bag_ops.embed_bag_segment_kernel

    def record(*args):
        calls.append(args)
        return wrapped(*args)

    embed_bag_ops.embed_bag_segment_kernel = record
    try:
        builder.pipeline.stream_runs(toks[:n_docs], segs[:n_docs],
                                     batch_size=BUILD_BATCH,
                                     max_uniq=BUILD_MAX_UNIQ)
    finally:
        embed_bag_ops.embed_bag_segment_kernel = wrapped
    table = builder.provider.table()
    mix = [c for c in calls if c[0] is table]
    lcp = [c for c in calls if c[0] is not table]
    if len(mix) != len(lcp):
        raise AssertionError(f"{len(mix)} provider-mix calls and "
                             f"{len(lcp)} log_cond_prob calls")
    return mix, lcp


def csr_call(table, rows, bins, n_bins):
    """The same segment sums as the CSR entry's arguments (the plain
    version's sort-based bags)."""
    return (table, *segment_bags(rows, bins, n_bins))


def segment_sweep_case(case, rng, dev, n_docs=6, n=512, n_bins=64,
                       v=9280):
    """rows and bins (n_docs, n) int64 of one SEGMENT_SWEEP case."""
    rows = rng.randint(0, v + 3, (n_docs, n))
    if case == "random":
        bins = rng.randint(0, n_bins // 2, (n_docs, n))   # half empty
        rows[rng.rand(n_docs, n) < 0.6] = -1
    elif case == "one_bin":
        bins = np.full((n_docs, n), 7)
    elif case == "one_per_bin":
        bins = np.tile(np.arange(n) % n_bins, (n_docs, 1))
        rows[:, n_bins:] = -1
    else:
        bins = rng.randint(-5, n_bins + 5, (n_docs, n))
        rows[rng.rand(n_docs, n) < 0.3] = -1
    return (torch.from_numpy(rows).to(dev),
            torch.from_numpy(bins).to(dev))


def check_embed_bag(mix, lcp, seed, dev):
    """Both entries against their plain versions on the card, bitwise:
    the segment entry (one launch that bags) against the sort-based
    plain path, and the CSR entry over the same sorted bags, on every
    captured build call (each launch twice: the same bits); then the CSR
    entry over the JAX-signature sweep of tests/test_kernels.py with
    empty bags, -1 entries and ids past the table, and the segment entry
    over SEGMENT_SWEEP, in float32 and bf16.  Returns the largest |diff|
    (0) and True."""
    for what, calls in (("provider mix", mix), ("log_cond_prob", lcp)):
        for c in calls:
            got = embed_bag_segment_kernel(*c)
            again = embed_bag_segment_kernel(*c)
            want = segment_bag_sums_plain(*c)
            csr = csr_call(*c)
            got_csr = embed_bag_kernel(*csr)
            want_csr = embed_bag_plain(*csr)
            torch.cuda.synchronize()
            assert_equal(got, want, f"embed_bag segment entry ({what})")
            assert_equal(got, again, f"embed_bag segment entry ({what}) "
                         "run to run")
            assert_equal(got_csr, want_csr, f"embed_bag CSR entry ({what})")
            assert_equal(got_csr.reshape(got.shape), got,
                         f"embed_bag CSR vs segment entry ({what})")
        table, rows, bins, n_bins = calls[0]
        live = int((rows >= 0).sum())
        log(f"phase 5: embed_bag == plain, both entries, bitwise, on the "
            f"build's {len(calls)} {what} calls: table "
            f"{tuple(table.shape)}, rows {tuple(rows.shape)} ({live} live "
            f"in the first), {n_bins} bins per doc")
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
            assert_equal(got, want, f"embed_bag CSR entry at {(v, d, b)}")
            if bool((got[-1] != 0).any()):
                raise AssertionError("an empty bag gave nonzero values")
    table32 = torch.from_numpy(rng.standard_normal((9280, 128))
                               .astype(np.float32)).to(dev)
    for case in SEGMENT_SWEEP:
        rows, bins = segment_sweep_case(case, rng, dev)
        for dt in (torch.float32, torch.bfloat16):
            c = (table32.to(dt), rows, bins, 64)
            got = embed_bag_segment_kernel(*c)
            want = segment_bag_sums_plain(*c)
            torch.cuda.synchronize()
            assert_equal(got, want, f"embed_bag segment entry [{case}, "
                         f"{dt}]")
    log(f"phase 5: embed_bag == plain, bitwise: the CSR entry over the "
        f"JAX-signature sweep {EB_SWEEP} (empty bags, -1 and past-table "
        f"ids), the segment entry over {SEGMENT_SWEEP} (6 docs x 512 "
        f"tokens, 64 bins), each in float32 and bf16")
    return 0.0, True


def embed_bag_cost(table, idx, ptr):
    """Bytes the CSR entry must move: the distinct live rows read once,
    the indices and bounds, and the bags written."""
    live = idx[idx >= 0].long().clamp(max=table.shape[0] - 1)
    rows = int(torch.unique(live).numel())
    n_bags = ptr.shape[0] - 1
    return ((rows + n_bags) * table.shape[1] * table.element_size()
            + idx.numel() * 4 + ptr.numel() * 4)


def segment_cost(table, rows, bins, n_bins):
    """Bytes the segment entry must move: the distinct live rows read
    once, rows and bins read, the (doc, bin) sums written."""
    live = rows[rows >= 0].long().clamp(max=table.shape[0] - 1)
    n_live = int(torch.unique(live).numel())
    n_docs = rows.numel() // rows.shape[-1]
    return ((n_live + n_docs * n_bins) * table.shape[1]
            * table.element_size() + rows.numel() * rows.element_size()
            + bins.numel() * bins.element_size())


def library_embedding_bag(table, idx, ptr):
    """``F.embedding_bag(mode="sum")`` over the same bags, with the
    skipped entries dropped first (it has no skip id): the library call
    that computes the same function.  Returns the call, its inputs
    prepared."""
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
    """embed_bag at the build's two shapes over up to 16 batches each:
    the segment entry (the build's path) and the CSR entry over the same
    bags (CUPTI), the plain version, ``F.embedding_bag`` on the prepared
    bags (the library yardstick, never used by the port), and with the
    launch cost of the whole call (CUDA events): the segment entry, the
    sort-based bagging + the CSR entry (the build's earlier path) and the same
    bagging + ``F.embedding_bag``.  Bounds: bytes over 3.35 TB/s (one add
    per value read is far below the float32 rate)."""
    out = {}
    for what, calls in (("mix", mix), ("lcp", lcp)):
        csrs = [csr_call(*c) for c in calls]
        ms, how, call_ms = timed([lambda c=c: embed_bag_segment_kernel(*c)
                                  for c in calls], 160, "embed_bag_segment")
        csr_ms, csr_how, csr_call_ms = timed(
            [lambda c=c: embed_bag_kernel(*c) for c in csrs], 160,
            "embed_bag_")
        sorted_ms = events_ms([lambda c=c: embed_bag_kernel(*csr_call(*c))
                               for c in calls], 160)
        plain_ms = events_ms([lambda c=c: segment_bag_sums_plain(*c)
                              for c in calls[:4]], 4)
        libs = [library_embedding_bag(*c) for c in csrs]
        for c, lib in zip(csrs, libs):
            torch.testing.assert_close(lib(), embed_bag_kernel(*c), **EB_TOL)
        lib_ms = timed(libs, 160, "EmbeddingBag")[0]
        lib_call_ms = events_ms(
            [lambda c=c: library_embedding_bag(*csr_call(*c))()
             for c in calls], 160)
        seg_bytes = sum(segment_cost(*c) for c in calls) / len(calls)
        csr_bytes = sum(embed_bag_cost(*c) for c in csrs) / len(csrs)
        b_ms, b_by = bound(seg_bytes, 0)
        csr_b_ms, csr_b_by = bound(csr_bytes, 0)
        out[what] = dict(ms=ms, timed_by=how, call_ms=call_ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         library_call_ms=lib_call_ms, sorted_call_ms=sorted_ms,
                         bound_ms=b_ms, bound_by=b_by,
                         csr=dict(ms=csr_ms, timed_by=csr_how,
                                  call_ms=csr_call_ms, bound_ms=csr_b_ms,
                                  bound_by=csr_b_by))
        t, rows, _, n_bins = calls[0]
        log(f"phase 5: embed_bag ({what}: table {tuple(t.shape)}, rows "
            f"{tuple(rows.shape)}, {n_bins} bins): segment entry {ms:.4f} "
            f"ms ({how}; {call_ms:.4f} ms with launch cost), bound "
            f"{b_ms:.5f} ms ({b_by}: {seg_bytes / 1e6:.2f} MB); CSR entry "
            f"over the same bags {csr_ms:.4f} ms ({csr_how}; "
            f"{csr_call_ms:.4f} ms with launch cost), bound {csr_b_ms:.5f} "
            f"ms; F.embedding_bag {lib_ms:.4f} ms; with the sort-based "
            f"bagging: + CSR entry {sorted_ms:.4f} ms, + F.embedding_bag "
            f"{lib_call_ms:.4f} ms; plain {plain_ms:.4f} ms")
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
    served, requests, noindex_p50 = serve_built(pidx, noindex, engine, ds,
                                                vocab, seed)
    round_trip(pidx)
    rows = [time_seg_interact(
        builder, toks, segs,
        {"build": built["seg_interact"],
         "noindex": served["noindex"]["seg_interact"]}, err, dev,
        requests, noindex_p50, unit_scale_max_abs_err=unit_err),
        time_embed_bag(mix, lcp, {"build": built["embed_bag"],
                                  "noindex": served["noindex"]["embed_bag"]},
                       eb_err, eb_bitwise, dev)]
    return rows, dict(pidx=pidx, engine=engine, ds=ds, vocab=vocab,
                      builder=builder, toks=toks, segs=segs)




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


class _Recording:
    """A front end seen through ``submit``: every future it returns is
    also appended to ``futures``; everything else is the front end's."""

    def __init__(self, fe, futures):
        self._fe, self._futures = fe, futures

    def submit(self, q, d):
        self._futures.append(self._fe.submit(q, d))
        return self._futures[-1]

    def __getattr__(self, name):
        return getattr(self._fe, name)


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
        # the run's futures, recorded by a wrapper that is not stored on
        # fe: a closure over fe.submit kept on fe would be a reference
        # cycle that holds the engine, and its index, on the card
        futures = []
        before = {n: metric(n) for n in FE_METRICS}
        launched = {n: fn.launches for n, fn in COUNTERS.items()}
        t0 = time.perf_counter()
        res = run_open_loop(_Recording(fe, futures), requests,
                            target_qps=qps, seed=seed, timeout=120)
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
        # a rejection read without raising it (see run_open_loop)
        if isinstance(f.exception(timeout=120), DeadlineExceeded):
            continue
        got = f.result(timeout=120)
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
    ctx["qps"] = qps
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
    ctx["coalesced_half_r"] = results.get("coalesce @ 0.5 R")
    same = all(np.array_equal(a, b) for a, b in
               zip(p_want, want[:FE_SWAP_REQUESTS]))
    log(f"phase 7: swap_engine to the packed copy: {len(reqs)} requests "
        f"after it == the packed engine's scores (bitwise; == the raw "
        f"scores too: {same}), cache epoch {epoch} -> {fe.cache.epoch}, "
        f"one swap counted")
    return results


# ---------------------------------------------------------------------------
# phase 8: the live index over phase 5's index, and the serve CLI
# ---------------------------------------------------------------------------

LIVE_DOCS = 4096         # docs 0-4,095 ingested again, as new ids
LIVE_CHUNKS = 4
LIVE_DEAD = 32           # tombstoned base docs, and as many inserted ones
LIVE_WAVE = 256          # requests at R / 2 while ingesting, and again
#                          while compacting
LIVE_QD_REQUESTS = 16
LIVE_AFTER = 8           # requests served after the compaction's swap
LIVE_SMALL = (2048, 1024)    # base and inserted docs of the rebuild check
LIVE_SMALL_TOP_K = 100
REPAIR_SEG = (65, 128, 130)
REPAIR_NB = (20, 1024, 1025, 2500)
CLI_METRICS = os.path.join(REPO, "build", "serve_metrics.txt")
# the in-process CLI runs: flags ("{metrics}": CLI_METRICS) and the kernels
# each must launch
CLI_RUNS = (
    (["--partition", "term", "--codec", "packed-q8", "--live",
      "--live-compact", "--target-qps", "200", "--coalesce",
      "--metrics-out", "{metrics}"],
     ("seg_interact", "embed_bag", "csr_lookup_packed", "knrm_pool")),
    (["--partition", "term", "--live", "--retrieve-k", "100"],
     ("seg_interact", "embed_bag", "lane_bounds", "retrieve_windows",
      "knrm_pool")),
    (["--compare-noindex"],
     ("seg_interact", "embed_bag", "csr_lookup", "knrm_pool")),
)
CLI_FAMILIES = (
    "seine_build_docs_total", "seine_build_batches_total",
    "seine_build_runs_total", "seine_build_docs_per_s",
    "seine_build_total_nnz", "seine_build_peak_host_bytes",
    "seine_merge_fan_in", "seine_shard_nnz", "seine_shard_count",
    "seine_shard_skew_max_ratio", "seine_shard_skew_mean_ratio",
    "seine_shard_hot_splits", "seine_plan_range_nnz",
    "seine_codec_tile_bits_total", "seine_live_docs",
    "seine_live_delta_nnz", "seine_live_delta_runs",
    "seine_live_tombstones", "seine_live_generation",
    "seine_live_ingest_docs_total", "seine_live_deletes_total",
    "seine_live_compactions_total", "seine_heartbeat_ranks",
    "seine_heartbeat_age_seconds", "seine_heartbeat_dead_ranks")
CLI_SPANS = ("build.stream_runs", "build.stage1.uniq",
             "build.stage2.interact", "build.stage2b.compact",
             "build.stage3.spill", "build.stage4.merge", "live.ingest",
             "live.compact")


def launch_counts():
    return {n: fn.launches for n, fn in COUNTERS.items()}


def counts_since(before):
    return {n: fn.launches - before[n] for n, fn in COUNTERS.items()}


def live_frontend(engine, **kw):
    """A front end as phase 7's coalesced mode runs it."""
    return ServingFrontend(engine, max_batch=FE_MAX_BATCH,
                           batch_timeout_ms=FE_TIMEOUT_MS, slo_ms=FE_SLO_MS,
                           **kw)


def live_wave(fe, requests, warm, qps: float, seed: int):
    """One open-loop run of ``requests`` at ``qps`` through ``fe`` after
    ``warm`` requests served uncounted; returns (result, futures, wall
    seconds, launches over the run)."""
    for f in [fe.submit(q, d) for q, d in warm]:
        f.result(timeout=120)
    fe.stats = type(fe.stats)()
    futures = []
    before = launch_counts()
    t0 = time.perf_counter()
    res = run_open_loop(_Recording(fe, futures), requests, target_qps=qps,
                        seed=seed, timeout=120)
    return res, futures, time.perf_counter() - t0, counts_since(before)


def wave_row(res, wall):
    st = res.stats
    return dict(p50=st.p50_ms, p95=st.p95_ms,
                queue_ms=st.queue_ms_per_request, goodput=res.goodput,
                served=res.n_served, rejected=res.n_rejected, wall_s=wall)


def fmt_row(r) -> str:
    return (f"p50 {r['p50']:.3f} ms, p95 {r['p95']:.3f} ms, queue "
            f"{r['queue_ms']:.3f} ms per request, goodput "
            f"{r['goodput']:.4f} ({r['served']} served, {r['rejected']} "
            f"rejected)")


def scores_of(engine, requests):
    with torch.inference_mode():
        return [engine.score(q, d).cpu().numpy() for q, d in requests]


def same_bits(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            raise AssertionError(f"{what}: request {i} differs (max |diff| "
                                 f"{np.abs(g - w).max()})")


def timed_compaction():
    """Wrap the compaction's two steps with host timers: the explode of
    the base to one host run, and the merger (the stage-4 merge on the
    host, then the upload of the new generation).  Returns the dict the
    timers fill and a function that undoes the wrapping."""
    times = {}
    explode, merge = live_mod._explode_base, live_mod.partitioned_from_runs

    def timing(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        return run

    live_mod._explode_base = timing("explode", explode)
    live_mod.partitioned_from_runs = timing("merge_and_upload", merge)

    def undo():
        live_mod._explode_base = explode
        live_mod.partitioned_from_runs = merge
    return times, undo


def upload_s(n_bytes: int, dev) -> float:
    """Seconds to copy ``n_bytes`` of pageable host memory to ``dev``, at
    the rate measured on one 1 GB copy (the new generation's upload is
    one such copy per array inside the merger)."""
    host = np.ones(1 << 28, np.float32)
    t0 = time.perf_counter()
    torch.from_numpy(host).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return n_bytes * (time.perf_counter() - t0) / host.nbytes


def live_ingest(live, toks, segs, n_docs: int, errors: list, secs: list):
    """Ingest docs 0 .. n_docs - 1 again in LIVE_CHUNKS chunks (a
    background thread's body); failures go to ``errors``."""
    try:
        t0 = time.perf_counter()
        chunk = -(-n_docs // LIVE_CHUNKS)
        for i in range(0, n_docs, chunk):
            live.insert(toks[i:i + chunk], segs[i:i + chunk],
                        batch_size=BUILD_BATCH)
        secs.append(time.perf_counter() - t0)
    except BaseException as e:
        errors.append(e)


def check_rebuild_contract(builder, toks, segs, params, queries, dev):
    """A live index over a LIVE_SMALL[0]-doc base with LIVE_SMALL[1] docs
    inserted equals build_partitioned of the same docs, on the card: nnz,
    M over every doc and the top-k ids, bitwise."""
    n_base, n_ins = LIVE_SMALL
    n = n_base + n_ins
    base = builder.build_partitioned(toks[:n_base], segs[:n_base], BUILD_K,
                                     batch_size=BUILD_BATCH,
                                     max_uniq=BUILD_MAX_UNIQ)
    live = LiveIndex(base, builder.pipeline, batch_size=BUILD_BATCH)
    live.insert(toks[n_base:n], segs[n_base:n])
    full = builder.build_partitioned(toks[:n], segs[:n], BUILD_K,
                                     batch_size=BUILD_BATCH,
                                     max_uniq=BUILD_MAX_UNIQ)
    if live.nnz != full.nnz or live.n_docs != full.n_docs:
        raise AssertionError(f"phase 8: live nnz {live.nnz} / docs "
                             f"{live.n_docs} != rebuild {full.nnz} / "
                             f"{full.n_docs}")
    e_live = SeineEngine(live, "knrm", params)
    e_full = SeineEngine(full, "knrm", params)
    docs = torch.arange(n, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for q in queries:
            qt = torch.from_numpy(np.asarray(q, np.int32)).to(dev)
            assert_equal(live.qd_matrix(qt, docs), full.qd_matrix(qt, docs),
                         "phase 8: live M vs the rebuild's")
            (sl, il), (sf, i_f) = (e_live.retrieve(q, LIVE_SMALL_TOP_K),
                                   e_full.retrieve(q, LIVE_SMALL_TOP_K))
            assert_equal(il, i_f, "phase 8: live top-k ids vs the rebuild's")
            assert_equal(sl, sf, "phase 8: live top-k scores vs the "
                         "rebuild's")
    log(f"phase 8: a {n_base}-doc base with {n_ins} docs inserted == "
        f"build_partitioned(K={BUILD_K}) of the {n} docs on the card: nnz "
        f"{live.nnz}, M over every doc and top-{LIVE_SMALL_TOP_K} ids and "
        f"scores of {len(queries)} queries (bitwise)")


def run_cli(dev):
    """repro_torch.launch.serve.main() in process, once per CLI_RUNS
    entry, with the launch counts zeroed just before and read just after;
    the first run's --metrics-out must hold the build's, partitioner's,
    live index's and heartbeat's families and spans."""
    os.makedirs(os.path.dirname(CLI_METRICS), exist_ok=True)
    argv0 = sys.argv
    out = []
    try:
        for flags, need in CLI_RUNS:
            argv = [a.replace("{metrics}", CLI_METRICS) for a in flags]
            if dev.type != "cuda":
                argv += ["--device", str(dev)]
            sys.argv = ["serve"] + argv
            obs.reset()
            for fn in COUNTERS.values():
                fn.launches = 0
            t0 = time.perf_counter()
            serve_cli.main()
            wall = time.perf_counter() - t0
            got = launch_counts()
            log(f"phase 8: CLI {' '.join(flags)}: {wall:.2f}s, launches "
                f"{got}")
            for name in need:
                if got[name] <= 0:
                    raise AssertionError(f"phase 8: the CLI ({' '.join(flags)})"
                                         f" did not launch {name}")
            out.append(dict(flags=flags, wall_s=wall, launches=got))
    finally:
        sys.argv = argv0
    with open(CLI_METRICS) as f:
        fams = obs.parse_prometheus(f.read())
    missing = [n for n in CLI_FAMILIES if n not in fams]
    spans = {dict(k)["span"] for k in fams.get("seine_span_count_total", {})}
    missing += [s for s in CLI_SPANS if s not in spans]
    if missing:
        raise AssertionError(f"phase 8: the CLI's metrics lack {missing}")
    log(f"phase 8: CLI metrics snapshot: {len(fams)} sample names, every "
        f"one of the {len(CLI_FAMILIES)} families and {len(CLI_SPANS)} "
        f"spans checked")
    return out


def check_repairs(builder, toks, segs, dev):
    """seg_interact past one block's 64 segments and knrm_pool past one
    staging chunk's 1,024, on the card against their plain versions, and
    timed beside their shapes on the main path."""
    out = {"seg_interact": {}, "knrm_pool": {}}
    e_term, e_tok, seg, term_ids = batch_inputs(builder, toks, segs, 0, dev)
    n_b = builder.cfg.n_segments
    g = torch.Generator().manual_seed(8)
    live_tok = (seg >= 0) & (seg < n_b)
    for n_seg in (n_b,) + REPAIR_SEG:
        s = seg
        if n_seg != n_b:
            draw = torch.sort(torch.randint(0, n_seg, seg.shape, generator=g),
                              dim=1).values.to(torch.int32).to(dev)
            s = torch.where(live_tok, draw, -1).contiguous()
        with torch.inference_mode():
            got = seg_interact_kernel(e_term, e_tok, s, term_ids, n_seg)
            want = seg_interact_plain(e_term, e_tok, s, term_ids, n_seg)
            torch.testing.assert_close(got, want, **SEG_TOL)
            ms, how, _ = timed([lambda s=s, n=n_seg: seg_interact_kernel(
                e_term, e_tok, s, term_ids, n)], 100, "seg_interact_kernel")
        out["seg_interact"][str(n_seg)] = dict(
            ms=ms, timed_by=how, max_abs_err=(got - want).abs().max().item())
    gen = torch.Generator(device=dev).manual_seed(9)
    for nb in REPAIR_NB:
        cos = (torch.rand((N_CAND, Q_SLOTS, nb), generator=gen, device=dev)
               * 2 - 1)
        mask = (torch.rand((N_CAND, nb), generator=gen, device=dev)
                > 0.25).float()
        got = knrm_pool_kernel(cos, mask)
        want = knrm_pool_ref(cos, mask)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        ms, how, _ = timed([lambda c=cos, m=mask: knrm_pool_kernel(c, m)],
                           100, "knrm_pool_kernel")
        out["knrm_pool"][str(nb)] = dict(
            ms=ms, timed_by=how, max_abs_err=(got - want).abs().max().item())
    for name, rows in out.items():
        log(f"phase 8: {name} at any segment count, against its plain "
            f"version on the card: " + ", ".join(
                f"{k}: {v['ms']:.4f} ms (max |diff| {v['max_abs_err']:.3g})"
                for k, v in rows.items()))
    return out


def phase8(ctx, seed: int, dev):
    """The live index at full width over phase 5's K = 4 index (module
    doc): ingest while the front end serves, tombstones, a compaction
    while it serves, the contract against a rebuild, the CLI, and the two
    repaired kernels.  Returns the repairs' rows."""
    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pidx, engine = ctx["pidx"], ctx["engine"]
    builder, toks, segs = ctx["builder"], ctx["toks"], ctx["segs"]
    n_base = pidx.n_docs
    n_ins = min(LIVE_DOCS, n_base)
    qps = ctx["qps"] / 2
    live = LiveIndex(pidx, builder.pipeline, batch_size=BUILD_BATCH)
    l_engine = SeineEngine(live, "knrm", engine.params)
    reqs = letor_requests(ctx["ds"], ctx["vocab"], seed + 5, LIVE_WAVE)
    reqs2 = letor_requests(ctx["ds"], ctx["vocab"], seed + 6, LIVE_WAVE)
    if max(int(d.max()) for _, d in reqs + reqs2) >= n_base:
        raise AssertionError("phase 8: a request holds a doc past the base")
    want = scores_of(engine, reqs)
    same_bits(scores_of(l_engine, reqs[:LIVE_QD_REQUESTS]),
              want[:LIVE_QD_REQUESTS], "phase 8: live scores before ingest")

    # ingest docs 0 .. n_ins - 1 again while the front end serves
    fe = live_frontend(l_engine)
    errors, secs = [], []
    before = launch_counts()
    thread = threading.Thread(target=live_ingest, args=(
        live, toks, segs, n_ins, errors, secs), name="phase8-ingest")
    try:
        thread.start()
        res, futures, wall, served_launches = live_wave(
            fe, reqs, reqs[:FE_MAX_BATCH], qps, seed)
        thread.join()
    finally:
        fe.close(timeout=600)
    if errors:
        raise errors[0]
    ingest = counts_since(before)
    chunk = -(-n_ins // LIVE_CHUNKS)
    n_batches = sum(-(-min(chunk, n_ins - i) // BUILD_BATCH)
                    for i in range(0, n_ins, chunk))
    if ingest["seg_interact"] != n_batches or             ingest["embed_bag"] < 2 * n_batches:
        raise AssertionError(f"phase 8: ingest of {n_batches} batches "
                             f"launched seg_interact "
                             f"{ingest['seg_interact']} and embed_bag "
                             f"{ingest['embed_bag']} times")
    for name in ("csr_lookup", "knrm_pool"):
        if served_launches[name] <= 0:
            raise AssertionError(f"phase 8: {name} was not launched "
                                 "serving during the ingest")
    served = check_served(futures, want, "phase 8 [during the ingest]")
    if served != res.n_served or served == 0:
        raise AssertionError(f"phase 8: {served} served, the run counted "
                             f"{res.n_served}")
    same_bits(scores_of(l_engine, reqs[:LIVE_QD_REQUESTS]),
              want[:LIVE_QD_REQUESTS], "phase 8: live scores after ingest")
    during_ingest = wave_row(res, wall)
    delta_nnz = live.delta_nnz
    log(f"phase 8: ingest of docs 0-{n_ins - 1} again as ids "
        f"{n_base}-{n_base + n_ins - 1} in {LIVE_CHUNKS} chunks: "
        f"{secs[0]:.2f}s = {n_ins / secs[0]:.1f} docs/s, delta_nnz "
        f"{live.delta_nnz}, launches {ingest}; meanwhile {LIVE_WAVE} "
        f"requests at {qps:.1f}/s (R / 2): {fmt_row(during_ingest)}; "
        f"every served score == phase 7's engine.score (bitwise), before "
        f"and after the ingest too")

    # the docs ingested again equal their originals, bitwise
    rng = np.random.RandomState(seed + 7)
    with torch.inference_mode():
        for q, _ in reqs[:LIVE_QD_REQUESTS]:
            d = rng.choice(n_ins, min(N_CAND, n_ins),
                           replace=False).astype(np.int32)
            qt = torch.from_numpy(q).to(dev)
            dd = torch.from_numpy(d).to(dev)
            assert_equal(live.qd_matrix(qt, dd + n_base),
                         live.qd_matrix(qt, dd),
                         "phase 8: M of docs ingested again")
            assert_equal(l_engine.score(q, d + n_base), l_engine.score(q, d),
                         "phase 8: scores of docs ingested again")
    log(f"phase 8: M and KNRM scores of docs {n_base} + i == those of doc i"
        f" over {LIVE_QD_REQUESTS} requests (bitwise)")

    # tombstones, then a compaction while the front end serves
    dead = np.concatenate([
        rng.choice(n_base, LIVE_DEAD, replace=False),
        n_base + rng.choice(n_ins, LIVE_DEAD, replace=False)])
    if live.delete(dead) != 2 * LIVE_DEAD:
        raise AssertionError("phase 8: the tombstones were not all new")
    want2 = scores_of(l_engine, reqs2)
    queries = [q for q, _ in reqs2[:N_RETRIEVE]]
    with torch.inference_mode():
        qd_before = [live.qd_matrix(torch.from_numpy(q).to(dev),
                                    torch.from_numpy(d).to(dev))
                     for q, d in reqs2[:LIVE_QD_REQUESTS]]
    top_before, _ = serve_retrieval(l_engine, queries, TOP_K)
    fe = live_frontend(l_engine, cache_tiles=FE_CACHE_TILES)
    times, undo = timed_compaction()
    try:
        epoch = fe.cache.epoch
        t0 = time.perf_counter()
        live.compact(wait=False)
        res, futures, wall, served_launches = live_wave(
            fe, reqs2, reqs2[:FE_MAX_BATCH], qps, seed + 1)
        live.wait_compaction()
        t_compact = time.perf_counter() - t0
        served = check_served(futures, want2,
                              "phase 8 [during the compaction]")
        after = [fe.submit(q, d) for q, d in reqs2[:LIVE_AFTER]]
        n_after = check_served(after, want2[:LIVE_AFTER],
                               "phase 8 [after the swap]")
        epoch_after = fe.cache.epoch
    finally:
        undo()
        fe.close(timeout=600)
    if served != res.n_served or served == 0 or n_after != LIVE_AFTER:
        raise AssertionError(f"phase 8: {served} / {n_after} served during"
                             " / after the compaction")
    if live.generation != 1 or epoch_after != epoch + 1:
        raise AssertionError(f"phase 8: generation {live.generation}, tile "
                             f"cache epoch {epoch} -> {epoch_after}")
    for name in ("knrm_pool",):
        if served_launches[name] <= 0:
            raise AssertionError(f"phase 8: {name} was not launched "
                                 "serving during the compaction")
    during_compact = wave_row(res, wall)
    with torch.inference_mode():
        for (q, d), m in zip(reqs2[:LIVE_QD_REQUESTS], qd_before):
            assert_equal(live.qd_matrix(torch.from_numpy(q).to(dev),
                                        torch.from_numpy(d).to(dev)), m,
                         "phase 8: M after the compaction")
        dead_m = live.qd_matrix(torch.from_numpy(queries[0]).to(dev),
                                torch.from_numpy(dead.astype(np.int32))
                                .to(dev))
        if (dead_m != 0).any():
            raise AssertionError("phase 8: a tombstoned doc has M rows")
    before = launch_counts()
    top_after, _ = serve_retrieval(l_engine, queries, TOP_K)
    scan = counts_since(before)
    for name in ("lane_bounds", "retrieve_windows", "knrm_pool"):
        if scan[name] <= 0:
            raise AssertionError(f"phase 8: {name} was not launched by the "
                                 "live first-stage scan")
    for (sb, ib), (sa, ia) in zip(top_before, top_after):
        if not (np.array_equal(ib, ia) and np.array_equal(sb, sa)):
            raise AssertionError("phase 8: top-k changed in the compaction")
        if np.isin(ia, dead).any():
            raise AssertionError("phase 8: a tombstoned doc in a top-k")
    up = upload_s(live.base.posting_nbytes, dev)
    log(f"phase 8: {2 * LIVE_DEAD} tombstones ({LIVE_DEAD} base, "
        f"{LIVE_DEAD} inserted), then compact(wait=False) while "
        f"{LIVE_WAVE} requests at {qps:.1f}/s: {fmt_row(during_compact)}; "
        f"compaction {t_compact:.2f}s: explode {times.get('explode', 0):.2f}"
        f"s, merge and upload {times.get('merge_and_upload', 0):.2f}s (the "
        f"upload of {live.base.posting_nbytes / 1e9:.2f} GB ~{up:.2f}s at "
        f"the rate of a 1 GB copy), the swap and the rest "
        f"{t_compact - sum(times.values()):.2f}s; generation "
        f"{live.generation}, tile cache epoch {epoch} -> {epoch_after}; "
        f"every score served during and after it == the view's before it "
        f"(bitwise), M of {LIVE_QD_REQUESTS} requests and top-{TOP_K} ids "
        f"and scores of {len(queries)} queries unchanged, no tombstoned "
        f"doc in a top-k, its M rows zero; scan launches {scan}")
    row7 = ctx.get("coalesced_half_r")
    if row7 is not None:
        log(f"phase 8: beside phase 7's coalesced R / 2 row: p50 "
            f"{row7['p50']:.3f} ms, p95 {row7['p95']:.3f} ms, queue "
            f"{row7['queue_ms']:.3f} ms, goodput {row7['goodput']:.4f}")
    del live, l_engine, fe, qd_before
    check_rebuild_contract(builder, toks, segs, engine.params,
                           queries[:N_RETRIEVE], dev)
    cli = run_cli(dev)
    repairs = check_repairs(builder, toks, segs, dev)
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else None)
    log(f"phase 8: delta_nnz before the compaction {delta_nnz}, generation "
        f"1, peak device memory "
        f"{'not measured' if peak is None else f'{peak:.2f} GB'}, wall "
        f"{time.perf_counter() - t_phase:.1f}s")
    return dict(repairs=repairs, during_ingest=during_ingest,
                during_compact=during_compact, cli=cli,
                ingest_docs_per_s=n_ins / secs[0],
                compaction_s=dict(times, total=t_compact))


# ---------------------------------------------------------------------------
# phase 9: ranker training over phase 5's index
# ---------------------------------------------------------------------------

TRAIN_STEPS = 200        # KNRM steps of TRAIN_BATCH pairs
TRAIN_BATCH = 16         # launch/train.py's PairSampler(batch_size=16)
TRAIN_CKPT_EVERY = 50
TRAIN_KEEP = 3           # fit's keep
TRAIN_RESUME_FROM = 100  # the checkpoints after it are deleted, then resumed
TRAIN_BAR = 20           # steps averaged at each end of KNRM's loss bar
DTB_STEPS = 40           # bench_table1.py::_train_briefly
DTB_BAR = 8              # tests/test_retrievers.py's bar: last 8 vs first 8
BAR_SLACK = 0.05
CPU_STEPS = 20           # train_seine_ranker on the card against the CPU
CLI_TRAIN_STEPS = 20
BUSY_STEPS = 8           # steps replayed under the profiler
TRAIN_TOL = dict(rtol=1e-5, atol=1e-6)     # knrm_pool's bar
CPU_TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_DIR = os.path.join(REPO, "build", "chip_smoke_train")
TRAIN_FAMILIES = ("seine_train_steps_total", "seine_train_loss",
                  "seine_train_step_seconds", "seine_ckpt_saves_total")
LETOR_METRICS = ("P@5", "P@10", "MAP", "nDCG@5", "nDCG@10")


class PlainLookupIndex:
    """``index`` whose ``qd_matrix`` runs the lookup kernel's plain
    version on the card (``plain_lookup``); every other attribute is the
    index's own."""

    def __init__(self, index):
        self._index = index

    def qd_matrix(self, q, docs):
        return plain_lookup(self._index, q, docs, POSTING_TILE)

    def __getattr__(self, name):
        return getattr(self._index, name)


@contextlib.contextmanager
def plain_knrm_pool():
    """KNRM's scorer through ``knrm_pool``'s plain version."""
    saved = knrm_retriever.knrm_pool
    knrm_retriever.knrm_pool = lambda c, m: knrm_pool_ref(
        c.to(torch.float32).contiguous(), m.to(torch.float32).contiguous())
    try:
        yield
    finally:
        knrm_retriever.knrm_pool = saved


def loss_fell(history, n: int, what: str) -> str:
    """The reference's bar: the mean loss of the last ``n`` steps at most
    the first ``n``'s + BAR_SLACK."""
    first = float(np.mean([h["loss"] for h in history[:n]]))
    last = float(np.mean([h["loss"] for h in history[-n:]]))
    if not last <= first + BAR_SLACK:
        raise AssertionError(f"phase 9: {what}'s loss did not fall: first "
                             f"{n} {first:.4f}, last {n} {last:.4f}")
    return f"{what} loss first {n} {first:.4f} -> last {n} {last:.4f}"


def check_first_step(pidx, queries, qrels, init, seed, dev):
    """The first training step's M, loss, grad norm and gradients through
    the kernels against the same through their plain versions, on the
    card: M bitwise, the rest at TRAIN_TOL."""
    sampler = PairSampler(qrels, np.arange(len(queries)),
                          batch_size=TRAIN_BATCH, seed=seed)
    batch = train_cli.pair_batches(sampler, queries, dev)(0)
    with torch.inference_mode():
        for qi, p, n in zip(batch["q"], batch["pos"], batch["neg"]):
            for d in (p[None], n[None]):
                assert_equal(pidx.qd_matrix(qi, d),
                             plain_lookup(pidx, qi, d, POSTING_TILE),
                             "phase 9: a training pair's M")
    out = {}
    for path in ("kernel", "plain"):
        params = copy.deepcopy(init)
        index = pidx if path == "kernel" else PlainLookupIndex(pidx)
        with (plain_knrm_pool() if path == "plain"
              else contextlib.nullcontext()):
            loss, grads = value_and_grad(
                train_cli.ranker_loss_fn("knrm", index), params, batch)
        out[path] = (loss, global_norm(grads), grads)
    (lk, nk, gk), (lp, np_, gp) = out["kernel"], out["plain"]
    torch.testing.assert_close(lk, lp, **TRAIN_TOL)
    torch.testing.assert_close(nk, np_, **TRAIN_TOL)
    err = 0.0
    for (name, a), (_, b) in zip(flatten_with_paths(gk),
                                 flatten_with_paths(gp)):
        torch.testing.assert_close(a, b, **TRAIN_TOL, msg=name)
        err = max(err, (a - b).abs().max().item())
    log(f"phase 9: the first step through the kernels == through their "
        f"plain versions on the card: {2 * TRAIN_BATCH} pairs' M bitwise, "
        f"loss {lk.item():.6f} / {lp.item():.6f}, grad norm "
        f"{nk.item():.6f} / {np_.item():.6f}, gradients max |diff| "
        f"{err:.3g} (rtol 1e-5 / atol 1e-6)")
    return lk.item(), nk.item()


def effectiveness(pidx, queries, qrels, runs):
    """Table 1's protocol: every query scores every doc through
    ``SeineEngine.score``; the LETOR metrics' means per ranker."""
    docs = np.arange(pidx.n_docs, dtype=np.int32)
    table = {}
    for label, retriever, params in runs:
        engine = SeineEngine(pidx, retriever, params)
        t0 = time.perf_counter()
        per_q = []
        for qi in range(len(queries)):
            s = engine.score(queries[qi], docs).float().cpu().numpy()
            per_q.append(evaluate_ranking(s, qrels[qi]))
        mm = mean_metrics(per_q)
        bad = [k for k in LETOR_METRICS
               if not (np.isfinite(mm[k]) and 0.0 <= mm[k] <= 1.0)]
        if bad:
            raise AssertionError(f"phase 9: {label}'s {bad} not in [0, 1]: "
                                 f"{mm}")
        table[label] = mm
        log(f"phase 9: effectiveness of {label} over {len(queries)} queries "
            f"x {pidx.n_docs} docs ({time.perf_counter() - t0:.2f}s): "
            + ", ".join(f"{k} {mm[k]:.4f}" for k in LETOR_METRICS))
    return table


def run_train_cli(dev):
    """repro_torch.launch.train.main() in process, counts zeroed just
    before and read just after; its obs snapshot holds TRAIN_FAMILIES."""
    argv0 = sys.argv
    cli_dir = os.path.join(TRAIN_DIR, "cli")
    sys.argv = ["train", "--workload", "seine-ranker", "--retriever",
                "knrm", "--steps", str(CLI_TRAIN_STEPS), "--ckpt-dir",
                cli_dir] + (["--device", str(dev)] if dev.type != "cuda"
                            else [])
    obs.reset()
    for fn in COUNTERS.values():
        fn.launches = 0
    try:
        t0 = time.perf_counter()
        train_cli.main()
        wall = time.perf_counter() - t0
    finally:
        sys.argv = argv0
    got = launch_counts()
    for name in ("csr_lookup", "knrm_pool"):
        if got[name] < CLI_TRAIN_STEPS:
            raise AssertionError(f"phase 9: the training CLI launched {name} "
                                 f"{got[name]} times in {CLI_TRAIN_STEPS} "
                                 "steps")
    fams = obs.snapshot()["metrics"]
    missing = [n for n in TRAIN_FAMILIES if n not in fams]
    if missing or metric("seine_train_steps_total") != CLI_TRAIN_STEPS \
            or metric("seine_ckpt_saves_total") < 1:
        raise AssertionError(f"phase 9: the training CLI's obs snapshot "
                             f"lacks {missing or TRAIN_FAMILIES}")
    log(f"phase 9: CLI --workload seine-ranker --retriever knrm --steps "
        f"{CLI_TRAIN_STEPS}: {wall:.2f}s, launches {got}, obs families "
        f"{', '.join(TRAIN_FAMILIES)} present")
    return dict(wall_s=wall, launches=got)


def phase9(ctx, seed: int, dev):
    """Ranker training over phase 5's K = 4 index (module doc): KNRM
    trained with checkpoints, resumed, held against the plain path on
    its first step and against the CPU; DeepTileBars; the LETOR metrics;
    the training CLI.  Returns the kernels' launches per step."""
    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    pidx, ds = ctx["pidx"], ctx["ds"]
    queries = pad_queries(ds.queries, ctx["vocab"].map_tokens, q_len=Q_SLOTS)
    qrels = ds.qrels
    n_b, functions = pidx.n_b, pidx.functions
    init = get_retriever("knrm").init(torch.Generator().manual_seed(seed),
                                      n_b, functions, device=dev)
    knrm_init = copy.deepcopy(init)
    ckpt_dir = os.path.join(TRAIN_DIR, "knrm")

    def train(params, steps, ckpt=None, retriever="knrm"):
        return train_cli.train_ranker(
            retriever, pidx, queries, qrels, params, steps, ckpt, seed=seed,
            verbose=False, ckpt_every=TRAIN_CKPT_EVERY)

    obs.reset()
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = train(init, TRAIN_STEPS, ckpt_dir)
    wall = time.perf_counter() - t0
    launched = launch_counts()
    per_step = {n: launched[n] / TRAIN_STEPS for n in ("csr_lookup",
                                                         "knrm_pool")}
    log(f"phase 9: KNRM {TRAIN_STEPS} steps x {TRAIN_BATCH} pairs over "
        f"{pidx.n_docs} docs (K={pidx.n_shards}, n_b {n_b}): {wall:.2f}s, "
        f"launches {launched}")
    for name in ("csr_lookup", "knrm_pool"):
        if launched[name] < TRAIN_STEPS:
            raise AssertionError(f"phase 9: {name} launched {launched[name]} "
                                 f"times in {TRAIN_STEPS} training steps")
    saves = obs.span_stats().get("ckpt.save")
    saves = saves.snapshot() if saves is not None else {}
    steps_kept = all_steps(ckpt_dir)
    want_kept = list(range(TRAIN_STEPS - (TRAIN_KEEP - 1) * TRAIN_CKPT_EVERY,
                           TRAIN_STEPS + 1, TRAIN_CKPT_EVERY))
    if steps_kept != want_kept:
        raise AssertionError(f"phase 9: checkpoints {steps_kept}, expected "
                             f"{want_kept}")
    sec = np.array([h["sec"] for h in res.history]) * 1e3
    p50, p95 = np.percentile(sec, 50), np.percentile(sec, 95)
    log(f"phase 9: ms per step p50 {p50:.3f} p95 {p95:.3f} (mean "
        f"{sec.mean():.3f}); ms per (q, d) training pair "
        f"{sec.mean() / TRAIN_BATCH:.4f} (Table 1's \"Training (ms)\": time "
        f"per step / {TRAIN_BATCH}); launches per step "
        + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
    bars = [loss_fell(res.history, TRAIN_BAR, "KNRM")]

    # resume: the checkpoints after TRAIN_RESUME_FROM go, fit() resumes
    t0 = time.perf_counter()
    for s in steps_kept:
        if s > TRAIN_RESUME_FROM:
            shutil.rmtree(os.path.join(ckpt_dir, f"ckpt_{s:010d}"))
    if latest_step(ckpt_dir) != TRAIN_RESUME_FROM:
        raise AssertionError(f"phase 9: latest checkpoint "
                             f"{latest_step(ckpt_dir)} after the deletes")
    resumed = train(copy.deepcopy(knrm_init), TRAIN_STEPS, ckpt_dir)
    t_resume = time.perf_counter() - t0
    if resumed.state.step != TRAIN_STEPS or \
            len(resumed.history) != TRAIN_STEPS - TRAIN_RESUME_FROM:
        raise AssertionError("phase 9: the resumed run did not start at "
                             f"step {TRAIN_RESUME_FROM}")
    err = 0.0
    for (name, a), (_, b) in zip(flatten_with_paths(resumed.state.params),
                                 flatten_with_paths(res.state.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)
        err = max(err, (a - b).abs().max().item())
    log(f"phase 9: deleted the step "
        f"{[s for s in steps_kept if s > TRAIN_RESUME_FROM]} checkpoints; "
        f"fit resumed at step {TRAIN_RESUME_FROM} and ran to "
        f"{TRAIN_STEPS} in {t_resume:.2f}s: final parameters == the "
        f"uninterrupted run's (max |diff| {err:.3g}, atol 1e-6)")

    loss0, norm0 = check_first_step(pidx, queries, qrels, knrm_init, seed,
                                    dev)
    for k, v in (("loss", loss0), ("grad_norm", norm0)):
        if not np.isclose(res.history[0][k], v, **TRAIN_TOL):
            raise AssertionError(f"phase 9: the run's first {k} "
                                 f"{res.history[0][k]} != {v}")

    dtb = train(get_retriever("deeptilebars").init(
        torch.Generator().manual_seed(seed), n_b, functions, device=dev),
        DTB_STEPS, retriever="deeptilebars")
    dtb_ms = np.mean([h["sec"] for h in dtb.history]) * 1e3
    bars.append(loss_fell(dtb.history, DTB_BAR, "DeepTileBars"))
    log(f"phase 9: DeepTileBars {DTB_STEPS} steps, {dtb_ms:.3f} ms per "
        f"step, {dtb_ms / TRAIN_BATCH:.4f} ms per pair; " + "; ".join(bars))

    table = effectiveness(pidx, queries, qrels, (
        ("BM25", "bm25", get_retriever("bm25").init(
            torch.Generator().manual_seed(seed), n_b, functions,
            device=dev)),
        ("KNRM at init", "knrm", knrm_init),
        (f"KNRM after {TRAIN_STEPS} steps", "knrm", res.state.params),
        (f"DeepTileBars after {DTB_STEPS} steps", "deeptilebars",
         dtb.state.params)))

    # train_seine_ranker on the card against the CPU, the same process
    t0 = time.perf_counter()
    card = train_cli.train_seine_ranker("knrm", CPU_STEPS, None, seed=seed,
                                        verbose=False, device=dev)
    cpu = train_cli.train_seine_ranker("knrm", CPU_STEPS, None, seed=seed,
                                       verbose=False, device="cpu")
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in card.history],
                                   [h[k] for h in cpu.history],
                                   **CPU_TRAIN_TOL, err_msg=k)
    diff = max(abs(a["loss"] - b["loss"])
               for a, b in zip(card.history, cpu.history))
    secs = time.perf_counter() - t0
    log(f"phase 9: train_seine_ranker(knrm, {CPU_STEPS}) on the card == on "
        f"the CPU: loss and grad norm histories at rtol 1e-4 / atol 1e-5 "
        f"(max loss |diff| {diff:.3g}; TF32 off), {secs:.2f}s")

    cli = run_train_cli(dev)

    busy = device_busy(lambda: train(copy.deepcopy(res.state.params),
                                     BUSY_STEPS), BUSY_STEPS)
    log(f"phase 9: the step loop: device busy {busy['ms']:.4f} ms per step "
        f"of {sec.mean():.4f} ms wall, {busy_share(busy, sec.mean())}, "
        f"{busy['ops']:.1f} device ops per step; most host self time per "
        f"step (profiled): {busy['host']}")
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else None)
    save_s = saves.get("total_s", 0.0)
    log(f"phase 9: checkpoints: {saves.get('count', 0)} async saves "
        f"({TRAIN_STEPS // TRAIN_CKPT_EVERY} + the last step again), "
        f"{save_s:.3f}s of writes in all (the ckpt.save span, off the "
        f"step loop's thread); peak device memory "
        f"{'not measured' if peak is None else f'{peak:.2f} GB'}; wall "
        f"{time.perf_counter() - t_phase:.1f}s")
    # phase 15 restores the last KNRM checkpoint onto a mesh
    keep = os.path.join(MESH_DIR, "knrm", f"ckpt_{steps_kept[-1]:010d}")
    shutil.rmtree(os.path.dirname(keep), ignore_errors=True)
    shutil.copytree(os.path.join(ckpt_dir, os.path.basename(keep)), keep)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return dict(launches=launched, per_step=per_step, p50_ms=p50,
                p95_ms=p95, ms_per_pair=sec.mean() / TRAIN_BATCH,
                effectiveness=table, cli=cli, busy=busy, peak_gb=peak,
                ckpt_save_s=save_s)


# ---------------------------------------------------------------------------
# phase 6: the LM bridge
# ---------------------------------------------------------------------------

def lm_config():
    return get_lm_config(LM_ARCH)


def param_count(params):
    """(parameters, bytes) of an LM tree."""
    tensors = [t for v in params.values()
               for t in (v.values() if isinstance(v, dict) else [v])]
    return (sum(t.numel() for t in tensors),
            sum(t.numel() * t.element_size() for t in tensors))


def fa_build_shape(lm):
    """(B, S, Hq, Hkv, hd) of the attention in one build batch."""
    return (LM_BATCH, BUILD_MAX_LEN, lm.n_heads, lm.n_kv_heads, lm.head_dim)


def qkv(shape, dtype, gen, dev):
    b, s, hq, hkv, hd = shape
    return [torch.randn(n, s, h, hd, generator=gen, device=dev).to(dtype)
            for n, h in ((b, hq), (b, hkv), (b, hkv))]


def check_flash_attn(lm, seed, dev, tag="phase 6", sweep=FA_SWEEP):
    """The kernel against its plain version on the card: the build's
    shape in bf16 (2e-2) on FA_SEEDS draws and in float32 (rtol 1e-4 /
    atol 1e-5), then the shapes of ``sweep`` in both types; two launches
    bitwise.  Returns the largest |diff| at the build's shape in bf16 and
    in float32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = fa_build_shape(lm)
    cases = [(shape, True, torch.bfloat16, seed + i)
             for i in range(FA_SEEDS)]
    cases += [(shape, True, torch.float32, None)]
    cases += [(c[:5], c[5], dt, None) for c in sweep
              for dt in (torch.float32, torch.bfloat16)]
    errs, used = [], []
    for shp, causal, dt, draw in cases:
        if draw is not None:
            g.manual_seed(draw)
        q, k, v = qkv(shp, dt, g, dev)
        got = flash_attn_kernel(q, k, v, causal=causal)
        again = flash_attn_kernel(q, k, v, causal=causal)
        want = flash_attn_plain(q, k, v, causal=causal).float()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"flash_attn differs between two launches "
                                 f"at {shp} {dt}")
        got = got.float()
        tol = BF16_TOL if dt == torch.bfloat16 else FA_F32_TOL
        torch.testing.assert_close(got, want, **tol)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attn gave non-finite values at "
                                 f"{shp}")
        err = (got - want).abs()
        errs.append(err.max().item())
        # the share of its bar the worst value takes
        used.append((err / (tol["atol"] + tol["rtol"] * want.abs()))
                    .max().item())
    bf, f32 = errs[:FA_SEEDS], errs[FA_SEEDS]
    rest = errs[FA_SEEDS + 1:] or [0.0]
    log(f"{tag}: flash_attn == plain at the build shape {shape} causal: "
        f"bf16 max |diff| {', '.join(f'{e:.3g}' for e in bf)} on draws "
        f"{seed}..{seed + FA_SEEDS - 1} (bar 2e-2 + 2e-2 |plain|; worst "
        f"value at {', '.join(f'{u:.0%}' for u in used[:FA_SEEDS])} of "
        f"its bar), float32 {f32:.3g} (bar rtol 1e-4/atol 1e-5, "
        f"{used[FA_SEEDS]:.0%}); over {len(sweep)} sweep shapes in "
        f"both types, largest |diff| {max(rest):.3g}, worst value at "
        f"{max(used[FA_SEEDS + 1:] or [0.0]):.0%} of its bar")
    return max(bf), f32


def check_lm_wiring(provider, toks, segs, dev):
    """The forward's wiring: one build batch's ``contextualize`` through
    the kernel against the same provider with the plain attention, on
    the card, at 2e-2, with the weights cast to float32 (a second copy),
    where the two attentions agree to ~1e-6, so the bar sees the layout,
    head grouping and mask alone.  In the working bf16, through the
    model's first LM_BF16_LAYERS layers (the depth of the port's bf16
    parity tests against the JAX model), at most LM_BF16_PAST of the
    values may lie past 2e-2: one-ulp differences of the attention
    output flip roundings downstream, and an attention that rounds p
    before P . V moves many more.  Over all layers the comparison is
    printed (largest |diff|, share of values past 2e-2)."""
    tb = torch.from_numpy(toks[:LM_BATCH]).to(dev)
    sb = torch.from_numpy(segs[:LM_BATCH]).to(dev)

    def both(cfg, params):
        with torch.inference_mode():
            return [LMProvider(cfg, params, provider.embed_dim,
                               proj=provider._proj, device=dev,
                               attention=attention).contextualize(tb, sb)
                    for attention in (None, flash_attn_plain)]

    def past(err, want):
        return (err > BF16_TOL["atol"]
                + BF16_TOL["rtol"] * want.abs()).float().mean().item()

    cut = {k: ({n: t[:LM_BF16_LAYERS] for n, t in v.items()}
               if isinstance(v, dict) else v)
           for k, v in provider.params.items()}
    got, want = both(dataclasses.replace(provider.cfg,
                                         n_layers=LM_BF16_LAYERS), cut)
    torch.cuda.synchronize()
    cut_err = (got - want).abs()
    cut_share = past(cut_err, want)
    if not bool(torch.isfinite(got).all()) or cut_share > LM_BF16_PAST:
        raise AssertionError(
            f"bf16 contextualize through {LM_BF16_LAYERS} layers: "
            f"{cut_share:.4%} of the values past 2e-2 of the plain "
            f"attention's (bar {LM_BF16_PAST:.1%})")
    del got, want, cut
    got, want = both(provider.cfg, provider.params)
    bf_err = (got - want).abs()
    bf_share = past(bf_err, want)
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
        f"{err:.3g}, values up to {want.abs().max().item():.3g}) and in "
        f"bf16 through {LM_BF16_LAYERS} layers (max |diff| "
        f"{cut_err.max().item():.3g}, {cut_share:.4%} of the values past "
        f"2e-2); in bf16 through all layers max |diff| "
        f"{bf_err.max().item():.3g}, {bf_share:.4%} of the values past "
        f"2e-2")
    return dict(f32=err, bf16_cut=cut_err.max().item(),
                bf16_cut_share=cut_share, bf16=bf_err.max().item(),
                bf16_share=bf_share)


def kernel_split(run, n: int):
    """Device ms per batch of ``run`` (``n`` batches): the CUPTI time of
    the kernels launched by the ops inside the MoE FFN's profiler ranges
    (MOE_RANGES) summed per range, whatever the kernels are; every other
    kernel's time summed by its name into GEMMs, flash_attn, its
    backward, seg_interact and the rest; and the rest's largest
    kernels.  A dense
    model's MoE classes stay 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    in_range = {name: 0.0 for name in MOE_RANGES}
    taken = {}                     # kernel name -> us launched in a range
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        op = e
        while op is not None and op.name not in MOE_RANGES:
            op = op.cpu_parent
        for k in e.kernels if op is not None else ():
            if k.name not in MOE_RANGES:    # the range's own GPU span
                in_range[op.name] += k.duration
                taken[k.name] = taken.get(k.name, 0.0) + k.duration
    total = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in MOE_RANGES \
                and not getattr(e, "is_user_annotation", False):
            total[e.name] = total.get(e.name, 0.0) + e.device_time_total
    split = dict(gemm=0.0, flash_attn=0.0, flash_attn_bwd=0.0,
                 seg_interact=0.0, **in_range, rest=0.0)
    rest = {}
    for name, us in total.items():
        us -= taken.get(name, 0.0)
        key = name.lower()
        if "flash_attn_bwd" in key:
            split["flash_attn_bwd"] += us
        elif "flash_attn" in key:
            split["flash_attn"] += us
        elif "seg_interact" in key:
            split["seg_interact"] += us
        elif any(g in key for g in GEMM_KERNELS):
            split["gemm"] += us
        else:
            split["rest"] += us
            rest[name[:60]] = rest.get(name[:60], 0.0) + us
    top = sorted(rest.items(), key=lambda kv: -kv[1])[:4]
    return ({k: v / 1e3 / n for k, v in split.items()},
            ", ".join(f"{k} {v / 1e3 / n:.2f} ms" for k, v in top))


def check_lm_on_the_fly(pidx, builder, toks, segs, dev, tag="phase 6"):
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
    log(f"{tag}: indexed == on-the-fly for all {int(present.sum())} "
        f"stored pairs of the first build batch ({union.size} terms x "
        f"{LM_BATCH} docs; max |diff| {err:.3g}, bar 1e-5)")


def serve_lm(pidx, builder, toks, segs, ds, vocab, seed, dev,
             tag="phase 6"):
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
        log(f"{tag} [{path}]: launches {counts[path]}; serve_batches "
            f"{len(reqs)} x ({Q_SLOTS} slots, {len(reqs[0][1])} "
            f"candidates): p50 {st.p50_ms:.3f} ms p95 {st.p95_ms:.3f} ms")
    err = 0.0
    for s, n in zip(out["indexed"][0], out["noindex"][0]):
        assert s.shape == (LM_CAND,) and np.isfinite(s).all()
        np.testing.assert_allclose(n, s[:LM_NOINDEX_CAND], **BF16_TOL)
        err = max(err, float(np.abs(n - s[:LM_NOINDEX_CAND]).max()))
    log(f"{tag}: No-Index scores == indexed scores at 2e-2 on "
        f"{LM_NOINDEX_REQUESTS} requests (largest |diff| {err:.3g})")
    return counts


def time_flash_attn(lm, launches, errs, dev, tag="phase 6",
                    name="flash_attn"):
    """flash_attn at the build's shape in bf16: the kernel (CUPTI), its
    plain version and ``F.scaled_dot_product_attention`` (the library
    yardstick, never used by the port; K and V repeated first when it
    lacks ``enable_gqa``); then the same three on float32 inputs (the
    split-TF32 kernel; TF32 is off, so the library call computes in
    float32 too).  The bounds: q, k, v read once and o written once over
    3.35 TB/s, or the causal flops (2 products x 2 hd per (query, key)
    pair at or below the diagonal) over 989 TFLOP/s in bf16, and in
    float32 over split TF32's 165 TFLOP/s and the FMAs' 67."""
    shape = fa_build_shape(lm)
    b, s, hq, hkv, hd = shape
    q, k, v = qkv(shape, torch.bfloat16, torch.Generator(device=dev)
                  .manual_seed(1), dev)
    flops = 4.0 * b * hq * hd * (s * (s + 1) / 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(q, k, v):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        try:
            sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
            return lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        except TypeError:                    # no enable_gqa: repeat K, V
            kr, vr = (x.repeat_interleave(hq // hkv, dim=1)
                      for x in (kt, vt))
            return lambda: sdpa(qt, kr, vr, is_causal=True)

    ms, how, call_ms = timed([lambda: flash_attn_kernel(q, k, v)], 50,
                             "flash_attn_kernel")
    plain_ms = events_ms([lambda: flash_attn_plain(q, k, v)], 5)
    library_ms = events_ms([library(q, k, v)], 50)
    n_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
    b_ms, b_by = bound(n_bytes, flops, BF16_FLOPS_PER_S)
    qf, kf, vf = q.float(), k.float(), v.float()
    f32_ms = timed([lambda: flash_attn_kernel(qf, kf, vf)], 20,
                   "flash_attn_kernel")[0]
    f32_plain_ms = events_ms([lambda: flash_attn_plain(qf, kf, vf)], 5)
    f32_library_ms = events_ms([library(qf, kf, vf)], 20)
    f32_bytes = 2 * (qf.numel() + kf.numel()) * qf.element_size()
    f32_b = f32_bounds(f32_bytes, flops)
    log(f"{tag}: flash_attn at {shape} causal bf16 (wgmma): {ms:.4f} ms "
        f"({how}; {call_ms:.4f} ms with launch cost) = "
        f"{flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.4f} ms; "
        f"scaled_dot_product_attention {library_ms:.4f} ms = "
        f"{flops / library_ms / 1e9:.1f} TFLOP/s; bound {b_ms:.5f} ms "
        f"({b_by}: {n_bytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP over "
        f"the bf16 peak)")
    log(f"{tag}: flash_attn on float32 inputs (split TF32, wgmma): "
        f"{f32_ms:.4f} ms = {flops / f32_ms / 1e9:.1f} TFLOP/s; plain "
        f"{f32_plain_ms:.4f} ms; scaled_dot_product_attention (float32, "
        f"TF32 off) {f32_library_ms:.4f} ms; {bounds_text(f32_b)} over "
        f"{f32_bytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP")
    return dict(name=name, route="cuda", shape=list(shape),
                source=KERNEL_SOURCE.format("flash_attn", "flash_attn"),
                replaces=TPU_KERNELS["flash_attn"],
                launches=launches["build"], launches_by_path=launches,
                max_abs_err=errs[0], f32_max_abs_err=errs[1], ms=ms,
                timed_by=how, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                f32_ms=f32_ms, f32_plain_ms=f32_plain_ms,
                f32_library_ms=f32_library_ms,
                **{f"f32_{k}": x for k, x in f32_b.items()})


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
    n_params, n_bytes = param_count(params)
    if n_params != lm.n_params:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{lm.n_params}")
    log(f"phase 6: {lm.name} ({lm.n_layers} layers, d_model {lm.d_model}, "
        f"{lm.n_heads}/{lm.n_kv_heads} heads of {lm.head_dim}, d_ff "
        f"{lm.d_ff}, vocab {lm.vocab_size}, {lm.dtype}): {n_params} "
        f"parameters, {n_bytes} bytes, drawn in "
        f"{time.perf_counter() - t0:.2f}s; table() "
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


# ---------------------------------------------------------------------------
# phase 10: the MoE LM through the LM bridge, and KV-cache decode
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-3b-a800m"
MOE_DOCS = 1024          # of phase 5's docs, as phase 6's LM_DOCS
DECODE_PROMPTS = 8
DECODE_PROMPT_LEN = 512
DECODE_STEPS = 64
DECODE_CHECK_LAYERS = 4
DROPLESS_CF = 5.0        # C >= M at top-8 of 40: no pair drops
DECODE_SLICES = 4
MERGE_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_extensions.py's bar


def moe_config():
    return get_lm_config(MOE_ARCH)


def build_moe_index(lm, params, cfg, vocab, toks, segs, seed, dev):
    """``build_partitioned(K=4)`` of ``toks`` through ``LMProvider`` over
    the MoE LM, launch counts zeroed just before and read just after,
    and the share of (token, slot) pairs each batch dropped."""
    provider = LMProvider(lm, params, cfg.embed_dim, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(seed + 7))
    ip = init_interaction_params(torch.Generator().manual_seed(seed + 1),
                                 cfg.embed_dim, device=dev)
    builder = IndexBuilder(cfg, vocab, provider, ip=ip, device=dev)
    # each dispatch's kept share over all pairs and over the pairs of the
    # docs' own tokens (pads enter the LM as token 0, as in the reference)
    real = torch.from_numpy(toks >= 0).to(dev).repeat_interleave(
        lm.moe.top_k, dim=1)
    kept = []
    route = T.moe_route

    def observed(*args, **kw):
        out = route(*args, **kw)
        m = out.pos < out.cap
        b = len(kept) // lm.n_layers
        r = real[b * LM_BATCH:(b + 1) * LM_BATCH]
        if r.shape != m.shape:
            raise AssertionError(f"dispatch {len(kept)} routes {m.shape}, "
                                 f"batch {b} holds {r.shape} pairs")
        kept.append(torch.stack([m.float().mean(), (m & r).sum() / r.sum()]))
        return out

    T.moe_route = observed
    try:
        for fn in COUNTERS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        pidx = builder.build_partitioned(toks, segs, LM_K,
                                         batch_size=LM_BATCH,
                                         max_uniq=BUILD_MAX_UNIQ)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        built = launch_counts()
    finally:
        T.moe_route = route
    st = builder.last_build_stats
    log(f"phase 10: build launches {built}")
    if built["flash_attn"] != lm.n_layers * st.n_batches:
        raise AssertionError(f"flash_attn launched {built['flash_attn']} "
                             f"times for {lm.n_layers} layers x "
                             f"{st.n_batches} batches")
    if built["seg_interact"] != st.n_batches:
        raise AssertionError(f"seg_interact launched {built['seg_interact']}"
                             f" times for {st.n_batches} batches")
    if built["embed_bag"] < st.n_batches:
        raise AssertionError(f"embed_bag launched {built['embed_bag']} "
                             f"times for {st.n_batches} batches")
    if len(kept) != lm.n_layers * st.n_batches:
        raise AssertionError(f"{len(kept)} MoE dispatches for "
                             f"{lm.n_layers} layers x {st.n_batches} batches")
    dropped = 1.0 - torch.stack(kept).reshape(st.n_batches, lm.n_layers, 2
                                              ).mean(1).cpu().numpy()
    cap = T.moe_capacity(toks.shape[1], lm.moe.top_k, lm.moe.n_experts,
                         lm.moe.capacity_factor)
    stage = ", ".join(f"{k} {v:.2f}s" for k, v in st.stage_s.items())
    log(f"phase 10: build_partitioned K={pidx.n_shards}: {st.n_docs} docs in "
        f"{wall:.2f}s ({st.n_docs / wall:.1f} docs/s end to end; stages "
        f"1-3 {st.build_s:.2f}s = {st.docs_per_s:.1f} docs/s), "
        f"{st.n_batches} batches; host seconds per stage: {stage}; nnz "
        f"{pidx.nnz}, posting_nbytes {pidx.posting_nbytes}")
    every, own = dropped[:, 0], dropped[:, 1]
    log(f"phase 10: (token, slot) pairs dropped per build batch at cf "
        f"{lm.moe.capacity_factor} (C = {cap} per {toks.shape[1]}-token "
        f"doc, top-{lm.moe.top_k} of {lm.moe.n_experts}; mean over the "
        f"layers): all pairs mean {every.mean():.4f} (min "
        f"{every.min():.4f}, max {every.max():.4f}), the pairs of the "
        f"docs' own tokens mean {own.mean():.4f} (min {own.min():.4f}, max "
        f"{own.max():.4f}; {(toks >= 0).mean():.4f} of the positions); by "
        f"batch " + " ".join(f"{a:.4f}/{b:.4f}" for a, b in dropped))
    return builder, pidx, built, st, wall, dropped


def greedy_decode(params, lm, prompts, steps):
    """``prefill_cache`` of the prompts, then ``steps`` greedy
    ``decode_step``s: (the step logits (steps + 1, B, V): the prefill's
    then each step's, the tokens fed (B, steps), ms per step, the
    cache)."""
    logits, cache = T.prefill_cache(params, prompts, lm,
                                    prompts.shape[1] + steps)
    out, fed, ms = [logits], [], []
    for _ in range(steps):
        tok = out[-1].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.decode_step(params, cache, tok, lm)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits)
        fed.append(tok)
    return torch.stack(out), torch.stack(fed, 1), ms, cache


def forward_logits(params, lm, tokens, first: int):
    """The forward's float32 logits at positions ``first`` onwards."""
    hidden, _ = T.forward(params, tokens, lm)
    return T.logits_of(params, hidden[:, first:], lm)


def greedy_agreement(got, want):
    """The share of positions where decode's and the forward's logits
    (B, T, V) pick the same greedy token; the median over positions of
    the forward's top-1 minus top-2 logit, and of the largest
    |decode - forward| over the vocabulary."""
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    top2 = want.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).median().item()
    diff = (got - want).abs().amax(-1).median().item()
    return agree, margin, diff


def check_decode(params, lm, prompts, dev):
    """Decode against the forward at full width, DECODE_CHECK_LAYERS
    layers, float32, capacity factor DROPLESS_CF: every
    step's logits equal the forward's at that position over the prompt
    and the tokens fed, at the reference's decode-vs-prefill bar (rtol
    2e-2 / atol 2e-2)."""
    n_l = min(DECODE_CHECK_LAYERS, lm.n_layers)
    cfg = dataclasses.replace(
        lm, n_layers=n_l, dtype="float32",
        moe=dataclasses.replace(lm.moe, capacity_factor=DROPLESS_CF))
    p32 = {k: ({n: t[:n_l].float() for n, t in v.items()}
               if isinstance(v, dict) else v.float())
           for k, v in params.items()}
    with torch.inference_mode():
        steps, fed, _, _ = greedy_decode(p32, cfg, prompts, DECODE_STEPS)
        full = torch.cat([prompts, fed], 1)
        want = forward_logits(p32, cfg, full, prompts.shape[1] - 1)
    torch.cuda.synchronize()
    got = steps.transpose(0, 1)                    # (B, steps + 1, V)
    torch.testing.assert_close(got, want, **BF16_TOL)
    err = (got - want).abs().max().item()
    agree, margin, diff = greedy_agreement(got, want)
    cap = T.moe_capacity(full.shape[1], cfg.moe.top_k, cfg.moe.n_experts,
                         cfg.moe.capacity_factor)
    log(f"phase 10: decode == forward, {n_l} layers at full "
        f"width in float32, cf {DROPLESS_CF} (C = {cap} of "
        f"{full.shape[1]} tokens: dropless): {DECODE_STEPS} steps of "
        f"{prompts.shape[0]} rows after a {prompts.shape[1]}-token prefill, "
        f"max |diff| {err:.3g} (bar rtol 2e-2 / atol 2e-2), logits up to "
        f"{want.abs().max().item():.3g}; greedy agreement {agree:.4f} "
        f"(median top-1 - top-2 margin {margin:.3g}, median largest "
        f"|diff| per position {diff:.3g})")
    return err


def check_merge(cache, seed, dev):
    """``combine_decode_stats`` over DECODE_SLICES slices of layer 0's
    cache against ``gqa_attention``'s decode output over the whole cache
    (rtol 1e-5 / atol 1e-5), with rows at lengths down to less than one
    slice, so later slices hold no valid position."""
    k, v = cache.k[0], cache.v[0]                  # (B, S, Hkv, hd)
    n_b, n_s, n_hkv, hd = k.shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(n_b, n_hkv * 3, hd, generator=g, device=dev)
    q = q.to(k.dtype)
    lengths = (n_s - torch.arange(n_b, device=dev) * (n_s // n_b)).to(
        torch.int32)
    s_loc = n_s // DECODE_SLICES
    stats = []
    for i in range(DECODE_SLICES):
        pos = i * s_loc + torch.arange(s_loc, device=dev)
        sl = slice(i * s_loc, (i + 1) * s_loc)
        stats.append(local_decode_stats(q, k[:, sl], v[:, sl],
                                        pos[None] < lengths[:, None]))
    got = combine_decode_stats(*[torch.stack([s[j] for s in stats])
                                 for j in range(3)])
    want = gqa_attention(q.float()[:, None], k, v, causal=False, chunk=n_s,
                         kv_valid_len=lengths)[:, 0]
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **MERGE_TOL)
    err = (got - want).abs().max().item()
    log(f"phase 10: combine_decode_stats over {DECODE_SLICES} slices of "
        f"layer 0's cache {tuple(k.shape)} == gqa_attention's decode "
        f"output (lengths {lengths.tolist()}; max |diff| {err:.3g}, bar "
        f"rtol 1e-5 / atol 1e-5)")
    return err


def decode_phase(params, lm, toks, seed, dev):
    """DECODE_PROMPTS prompts of DECODE_PROMPT_LEN tokens (phase 5's
    docs, pads as token 0) prefilled, then DECODE_STEPS greedy steps at
    full depth in bf16: ms per step, tokens/s, cache bytes, and the
    share of steps whose greedy token equals that of the forward over the
    same tokens at the dropless capacity factor DROPLESS_CF (decode, at
    M = 1, never drops a pair); then the float32 check and the merge."""
    prompts = torch.from_numpy(toks[:DECODE_PROMPTS, :DECODE_PROMPT_LEN]
                               ).clamp(min=0).to(dev)
    with torch.inference_mode():
        greedy_decode(params, lm, prompts, 2)                   # warm-up
        for fn in COUNTERS.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps, fed, ms, cache = greedy_decode(params, lm, prompts,
                                              DECODE_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = launch_counts()
        full = torch.cat([prompts, fed], 1)
        dropless = dataclasses.replace(lm, moe=dataclasses.replace(
            lm.moe, capacity_factor=DROPLESS_CF))
        want = forward_logits(params, dropless, full, prompts.shape[1] - 1)
    agree, margin, diff = greedy_agreement(steps.transpose(0, 1), want)
    if not bool(torch.isfinite(steps).all()):
        raise AssertionError("decode gave non-finite logits")
    if launched["flash_attn"] != lm.n_layers:
        raise AssertionError(f"the prefill launched flash_attn "
                             f"{launched['flash_attn']} times for "
                             f"{lm.n_layers} layers")
    cache_bytes = (cache.k.numel() + cache.v.numel()) * cache.k.element_size()
    p50, p95 = np.percentile(ms, 50), np.percentile(ms, 95)
    log(f"phase 10: decode {prompts.shape[0]} x {prompts.shape[1]} prompt "
        f"tokens prefilled, then {DECODE_STEPS} greedy decode_steps in "
        f"{lm.dtype} at full depth: ms per step p50 {p50:.3f} / p95 "
        f"{p95:.3f} (mean {np.mean(ms):.3f}), "
        f"{prompts.shape[0] * DECODE_STEPS / (sum(ms) / 1e3):.1f} tokens/s "
        f"over the steps; prefill and steps {wall:.2f}s; KV cache "
        f"{cache_bytes} bytes ({tuple(cache.k.shape)} x 2, "
        f"{cache.k.dtype}); launches {launched}; greedy agreement with "
        f"the bf16 forward over the same {full.shape[1]} tokens at the "
        f"dropless cf {DROPLESS_CF} {agree:.4f} (the forward's median "
        f"top-1 - top-2 logit margin {margin:.3g}; median over positions "
        f"of the largest |decode - forward| {diff:.3g})")
    f32_err = check_decode(params, lm, prompts, dev)
    merge_err = check_merge(cache, seed, dev)
    return dict(p50_ms=p50, p95_ms=p95,
                tokens_per_s=prompts.shape[0] * DECODE_STEPS
                / (sum(ms) / 1e3), cache_bytes=cache_bytes,
                greedy_agreement=agree, greedy_margin=margin,
                logit_diff=diff, f32_max_abs_err=f32_err,
                merge_max_abs_err=merge_err)


def phase10(seed: int, dev, corpus):
    """The MoE LM at granite-moe-3b-a800m's full width and depth through
    the LM bridge, and KV-cache decode (module doc), over phase 5's
    corpus."""
    t_phase = time.perf_counter()
    cfg, ds, vocab, toks, segs, _ = corpus
    toks, segs = toks[:MOE_DOCS], segs[:MOE_DOCS]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    lm = moe_config()
    t0 = time.perf_counter()
    params = T.init_params(lm, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    torch.cuda.synchronize()
    n_params, n_bytes = param_count(params)
    if n_params != lm.n_params:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{lm.n_params}")
    log(f"phase 10: {lm.name} ({lm.n_layers} layers, d_model {lm.d_model}, "
        f"{lm.n_heads}/{lm.n_kv_heads} heads of {lm.head_dim}, "
        f"{lm.moe.n_experts} experts top-{lm.moe.top_k} of d_expert "
        f"{lm.moe.d_expert}, cf {lm.moe.capacity_factor}, vocab "
        f"{lm.vocab_size}, {lm.dtype}, router float32): {n_params} "
        f"parameters, {n_bytes} bytes, drawn in "
        f"{time.perf_counter() - t0:.2f}s")
    fa_errs = check_flash_attn(lm, seed, dev, tag="phase 10", sweep=())
    builder, pidx, built, st, wall, dropped = build_moe_index(
        lm, params, cfg, vocab, toks, segs, seed, dev)
    n_split = min(2, st.n_batches)
    split = kernel_split(lambda: builder.pipeline.stream_runs(
        toks[:n_split * LM_BATCH], segs[:n_split * LM_BATCH],
        batch_size=LM_BATCH, max_uniq=BUILD_MAX_UNIQ), n_split)
    parts = None
    if split is not None:
        parts, rest = split
        if not all(parts[name] > 0 for name in MOE_RANGES):
            raise AssertionError(f"the profile put no kernel time in some "
                                 f"of moe_ffn's ranges: {parts}")
        log(f"phase 10: device ms per build batch (CUPTI, {n_split} "
            f"batches): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      parts.items())
            + f"; total {sum(parts.values()):.2f}; largest of the rest: "
            f"{rest}")
    check_lm_on_the_fly(pidx, builder, toks, segs, dev, tag="phase 10")
    served = serve_lm(pidx, builder, toks, segs, ds, vocab, seed, dev,
                      tag="phase 10")
    del builder, pidx
    decode = decode_phase(params, lm, toks, seed, dev)
    row = time_flash_attn(lm, {"build": built["flash_attn"],
                               "noindex": served["noindex"]["flash_attn"]},
                          fa_errs, dev, tag="phase 10",
                          name="flash_attn_hd64")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    log(f"phase 10: peak device memory "
        f"{peak if peak is not None else 'not measured'} bytes; phase "
        f"{time.perf_counter() - t_phase:.1f}s")
    row.update(peak_bytes=peak, build_docs_per_s=st.n_docs / wall,
               build_split_ms=parts,
               dropped_share=float(dropped[:, 0].mean()),
               dropped_share_own_tokens=float(dropped[:, 1].mean()),
               decode=decode)
    return row


# ---------------------------------------------------------------------------
# phase 11: the SNRM baseline
# ---------------------------------------------------------------------------

SNRM_LATENT = 128        # bench_snrm.py
SNRM_LR = 3e-3
SNRM_STEPS = 80
SNRM_BATCH = 16
SNRM_TOL = dict(rtol=1e-4, atol=1e-5)
SNRM_METRICS = ("P@5", "P@10", "MAP")


def snrm_batches(queries, qrels, toks, seed):
    """bench_snrm.py's sampler: SNRM_BATCH queries, a relevant and a
    non-relevant doc for each."""
    rng = np.random.RandomState(seed)
    for _ in range(SNRM_STEPS):
        qi = rng.randint(0, len(queries), SNRM_BATCH)
        pos, neg = [], []
        for q in qi:
            rel = np.flatnonzero(qrels[q] > 0)
            nrel = np.flatnonzero(qrels[q] == 0)
            pos.append(rel[rng.randint(rel.size)] if rel.size else 0)
            neg.append(nrel[rng.randint(nrel.size)] if nrel.size else 1)
        yield {"query": queries[qi], "pos": toks[pos], "neg": toks[neg]}


def on(batch, dev):
    return {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in batch.items()}


def phase11(seed: int, dev, corpus, seine):
    """SNRM (core/snrm.py) over phase 5's corpus and queries with
    bench_snrm.py's recipe: the first step on the card against the CPU,
    SNRM_STEPS steps, every doc encoded in chunks, dot-latent retrieval
    over all docs per query, P@k / MAP and the latent density beside
    phase 9's rows (``seine``: label -> metrics, BM25 among them)."""
    t_phase = time.perf_counter()
    cfg, ds, vocab, toks, segs, _ = corpus
    queries = pad_queries(ds.queries, vocab.map_tokens, q_len=Q_SLOTS)
    qrels = ds.qrels
    params = snrm.init_snrm(vocab.size, SNRM_LATENT,
                            generator=torch.Generator(device=dev)
                            .manual_seed(seed), device=dev)
    opt = adam(SNRM_LR)
    state = opt.init(params)
    batches = snrm_batches(queries, qrels, toks, seed)
    first = next(batches)
    loss, grads = value_and_grad(snrm.snrm_loss, params, on(first, dev))
    host = {k: v.cpu() for k, v in params.items()}
    cpu_loss, cpu_grads = value_and_grad(snrm.snrm_loss, host,
                                         on(first, "cpu"))
    torch.testing.assert_close(loss.cpu(), cpu_loss, **SNRM_TOL)
    err = 0.0
    for k in params:
        torch.testing.assert_close(grads[k].cpu(), cpu_grads[k], **SNRM_TOL,
                                   msg=k)
        err = max(err, (grads[k].cpu() - cpu_grads[k]).abs().max().item())
    log(f"phase 11: SNRM's first step on the card == the CPU's: loss "
        f"{loss.item():.6f} / {cpu_loss.item():.6f}, gradients max |diff| "
        f"{err:.3g} (rtol 1e-4 / atol 1e-5)")
    losses, ms = [], []
    for batch in [first, *batches]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(snrm.snrm_loss, params, on(batch, dev))
        upd, state = opt.update(grads, state, params)
        params = apply_updates(params, upd)
        losses.append(loss)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError("SNRM's loss is not finite")
    t0 = time.perf_counter()
    z = snrm.encode_docs(params, toks)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    if tuple(z.shape) != (toks.shape[0], SNRM_LATENT) \
            or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"SNRM encodings {tuple(z.shape)} not finite")
    t0 = time.perf_counter()
    with torch.inference_mode():
        zq = snrm.encode(params, torch.from_numpy(queries).to(dev))
        scores = (zq @ z.T).cpu().numpy()
    per_q = [evaluate_ranking(scores[i], qrels[i])
             for i in range(len(queries))]
    mm = mean_metrics(per_q)
    density = (z > 0).float().mean().item()
    log(f"phase 11: SNRM d_latent {SNRM_LATENT}, adam({SNRM_LR}) "
        f"{SNRM_STEPS} steps of {SNRM_BATCH} (q, pos, neg): ms per step p50 "
        f"{np.percentile(ms, 50):.3f} / p95 {np.percentile(ms, 95):.3f}, "
        f"loss first 8 {losses[:8].mean():.4f} -> last 8 "
        f"{losses[-8:].mean():.4f}; {toks.shape[0]} docs encoded in "
        f"chunks of {snrm.ENCODE_CHUNK} in {enc_s:.2f}s, latent density "
        f"{density:.4f}; dot-latent retrieval over all docs for "
        f"{len(queries)} queries ({time.perf_counter() - t0:.2f}s)")
    log("phase 11: effectiveness " + "; ".join(
        f"{label}: " + ", ".join(f"{k} {m[k]:.4f}" for k in SNRM_METRICS)
        for label, m in [("SNRM", mm)] + [(f"{k} (phase 9)", v)
                                          for k, v in seine.items()])
        + f"; phase {time.perf_counter() - t_phase:.1f}s")
    return dict(metrics={k: mm[k] for k in SNRM_METRICS}, density=density,
                losses=losses, first_step_err=err,
                p50_ms=float(np.percentile(ms, 50)))


# ---------------------------------------------------------------------------
# phase 12: LM training on the card
# ---------------------------------------------------------------------------

TRAIN_LM_ARCH = "stablelm-1.6b"
TRAIN_LM_STEPS = 8
MOE_TRAIN_LAYERS = 4     # of granite-moe's 32: cut for the run's time
MOE_TRAIN_STEPS = 2
MOE_TRAIN_BATCH = (8, 1024)
RESUME_LAYERS = 2        # a full-width stablelm cut to 2 layers
RESUME_STEPS = 3         # a checkpoint at step 2, resumed for step 3
LM_TRAIN_DIR = os.path.join(REPO, "build", "chip_smoke_lm")
# (B, S, Hq, Hkv, hd, causal): stablelm-1.6b's training shape, then
# granite-moe's and minitron-4b's at S 1,024, and a tail length causal
# and full
FA_BWD_SHAPES = ((16, 1024, 32, 32, 64, True), (8, 1024, 24, 8, 64, True),
                 (4, 1024, 24, 8, 128, True), (1, 1000, 8, 2, 64, True),
                 (1, 1000, 8, 2, 64, False))
# checked in float32 only: BERT4Rec's training attention (B4R_FA_SHAPE)
# and the LM build's shape (PERF.md row 8f), also timed in float32
FA_BWD_F32_SHAPES = ((256, 200, 2, 2, 32, False),
                     (32, 512, 24, 8, 128, True))
FA_BWD_PAST = 1e-3       # bf16: the share of values past 2e-2 (row 8's)
FA_BWD_ITERS = 10


def train_lm_config(name: str, n_layers=None):
    cfg = get_lm_config(name)
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def bwd_inputs(shape, dtype, gen, dev):
    """q, k, v, dO of a backward shape, and the kernel's o and lse."""
    b, s, hq, hkv, hd, causal = shape
    q, k, v = qkv((b, s, hq, hkv, hd), dtype, gen, dev)
    do = torch.randn(b, s, hq, hd, generator=gen, device=dev).to(dtype)
    o, lse = flash_attn_kernel(q, k, v, causal=causal, return_lse=True)
    return q, k, v, o, do, lse


def check_flash_attn_bwd(seed, dev):
    """The backward kernel against its plain version on the card at
    FA_BWD_SHAPES (both types) and FA_BWD_F32_SHAPES (float32), from the
    forward kernel's o and lse: float32 at rtol 1e-4 / atol 1e-5, bf16 at
    most FA_BWD_PAST of the values past 2e-2; two launches bitwise; the
    forward's lse against the plain forward's (float32 bar) and its o
    bitwise equal to a launch without lse; each type's distance from the
    plain mirror of its operands (``bf16_parts`` / ``tf32_parts``).
    Returns {shape: {dtype: (largest |diff| over dQ, dK, dV, share past
    2e-2, mirror |diff|)}}."""
    g = torch.Generator(device=dev).manual_seed(seed)
    errs = {}
    both = (torch.float32, torch.bfloat16)
    for shape, dtypes in [(s, both) for s in FA_BWD_SHAPES] + [
            (s, (torch.float32,)) for s in FA_BWD_F32_SHAPES]:
        causal = shape[5]
        for dt in dtypes:
            q, k, v, o, do, lse = bwd_inputs(shape, dt, g, dev)
            if not torch.equal(o, flash_attn_kernel(q, k, v, causal=causal)):
                raise AssertionError(f"flash_attn's o with lse != without, "
                                     f"{shape} {dt}")
            torch.testing.assert_close(lse, flash_attn_plain(
                q, k, v, causal=causal, return_lse=True)[1], **FA_F32_TOL)
            got = flash_attn_bwd_kernel(q, k, v, o, do, lse, causal=causal)
            again = flash_attn_bwd_kernel(q, k, v, o, do, lse, causal=causal)
            want = flash_attn_bwd_plain(q, k, v, o, do, lse, causal=causal)
            torch.cuda.synchronize()
            worst, past = 0.0, 0.0
            # the kernel's own operand rounding
            parts = ("bf16_parts" if dt == torch.bfloat16
                     else "tf32_parts")
            mirror = max((a.float() - m.float()).abs().max().item()
                         for a, m in zip(got, flash_attn_bwd_plain(
                             q, k, v, o, do, lse, causal=causal,
                             **{parts: True})))
            for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
                if not torch.equal(a, a2):
                    raise AssertionError(f"flash_attn_bwd's {name} differs "
                                         f"between two launches at {shape}")
                a, w = a.float(), w.float()
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"flash_attn_bwd's {name} is not "
                                         f"finite at {shape}")
                if dt == torch.float32:
                    torch.testing.assert_close(a, w, **FA_F32_TOL, msg=name)
                else:
                    off = ((a - w).abs() > BF16_TOL["atol"] + BF16_TOL["rtol"]
                           * w.abs()).float().mean().item()
                    if off > FA_BWD_PAST:
                        raise AssertionError(
                            f"flash_attn_bwd's {name} at {shape}: {off:.2e} "
                            f"of the values past 2e-2")
                    past = max(past, off)
                worst = max(worst, (a - w).abs().max().item())
            errs.setdefault(shape, {})[dt] = (worst, past, mirror)
    log("phase 12: flash_attn_bwd == plain from the forward kernel's o and "
        "lse, two launches bitwise, o with and without lse bitwise, lse at "
        "rtol 1e-4/atol 1e-5: " + "; ".join(
            f"{s}: float32 {e[torch.float32][0]:.3g} "
            f"({e[torch.float32][2]:.3g} from the split-TF32 mirror)" + (
                f", bf16 {e[torch.bfloat16][0]:.3g} "
                f"({e[torch.bfloat16][1]:.1e} past 2e-2; "
                f"{e[torch.bfloat16][2]:.3g} from the two-part mirror)"
                if torch.bfloat16 in e else "")
            for s, e in errs.items()))
    return errs


def per_call_ms(fns, iters: int, kernel: str):
    """(device ms per call of the kernels whose names hold ``kernel``, how
    it was timed): the sum over those kernels of each one's mean CUPTI
    time per record (each runs once a call), so that records the
    profiler drops late in this script do not count as free calls; or
    CUDA events per call when it records none."""
    prof = device_profile(fns, iters)
    if prof is not None:
        hits = [(t, n) for key, (t, n) in prof.items() if kernel in key]
        if hits and sum(t for t, _ in hits) > 0:
            return (sum(t / n for t, n in hits),
                    f"cupti, {sum(n for _, n in hits)} of "
                    f"{len(hits) * iters} kernel records over {iters} "
                    f"calls")
    return events_ms(fns, iters), "events"


def attention_pairs(b, s, hq, causal) -> float:
    """(query, key) pairs attention computes: at or below the diagonal
    under the causal mask."""
    return b * hq * (s * (s + 1) / 2 if causal else s * s)


def time_flash_attn_bwd(seed, dev):
    """Per FA_BWD_SHAPES shape in bf16: the backward kernel's device ms
    per call (both its kernels, CUPTI), with launch cost, its plain
    version's ms and the backward of ``F.scaled_dot_product_attention``
    (``enable_gqa``; the library yardstick, never used by the port); the
    bound: q, k, v, o, dO and lse read once, dQ, dK, dV written once,
    over 3.35 TB/s, or the five products' 10 hd flops per attended pair
    over the bf16 989 TFLOP/s; beside it the bf16 design's bound, its 20
    hd flops a pair over the same peak, and the TFLOP/s against each; at
    the first shape the same on float32 inputs, and last the float32
    forward and backward at FA_BWD_F32_SHAPES' LM build shape (row 8f),
    float32 against split TF32's 165 TFLOP/s and the FMAs' 67
    (``f32_bounds``)."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    timed_shapes = [(s, (torch.bfloat16, torch.float32) if i == 0
                     else (torch.bfloat16,))
                    for i, s in enumerate(FA_BWD_SHAPES)]
    timed_shapes.append((FA_BWD_F32_SHAPES[1], (torch.float32,)))
    for shape, dtypes in timed_shapes:
        b, s, hq, hkv, hd, causal = shape
        flops = 10.0 * hd * attention_pairs(b, s, hq, causal)
        for dt in dtypes:
            q, k, v, o, do, lse = bwd_inputs(shape, dt, g, dev)
            call = [lambda: flash_attn_bwd_kernel(q, k, v, o, do, lse,
                                                  causal=causal)]
            ms, how = per_call_ms(call, FA_BWD_ITERS, "flash_attn_bwd_")
            call_ms = events_ms(call, FA_BWD_ITERS)
            plain_ms = events_ms([lambda: flash_attn_bwd_plain(
                q, k, v, o, do, lse, causal=causal)], 1)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
            dot = do.transpose(1, 2)
            library_ms = events_ms([lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True)], FA_BWD_ITERS)
            del out
            # q, o, dO and dQ have q's size; k, v, dK and dV k's
            n_bytes = 4 * (q.numel() + k.numel()) * q.element_size() \
                + lse.numel() * 4
            if dt == torch.bfloat16:
                b_ms, b_by = bound(n_bytes, flops, BF16_FLOPS_PER_S)
                bounds = dict(bound_ms=b_ms, bound_by=b_by)
            else:
                bounds = f32_bounds(n_bytes, flops)
                b_ms, b_by = bounds["bound_ms"], bounds["bound_by"]
            row = dict(shape=list(shape), dtype=str(dt)[6:], ms=ms,
                       timed_by=how, call_ms=call_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bytes=n_bytes, flops=flops,
                       tflops=flops / ms / 1e9, **bounds)
            design = ""
            if dt == torch.bfloat16:
                # S and dP twice, dQ, dK and dV from two bf16 parts each
                row["design_flops"] = 2.0 * flops
                row["design_bound_ms"], row["design_bound_by"] = bound(
                    n_bytes, 2.0 * flops, BF16_FLOPS_PER_S)
                row["design_tflops"] = 2.0 * flops / ms / 1e9
                design = (f"; the design's 20 hd bound "
                          f"{row['design_bound_ms']:.5f} ms "
                          f"({row['design_bound_by']}), "
                          f"{row['design_tflops']:.1f} TFLOP/s of its "
                          f"{2.0 * flops / 1e9:.1f} GFLOP")
            else:
                design = f"; {bounds_text(bounds)}"
            if dt == torch.float32 and shape == FA_BWD_F32_SHAPES[1]:
                # the forward beside it, as phase 6 times it at this shape
                f_flops = 4.0 * hd * attention_pairs(b, s, hq, causal)
                row["fwd_ms"], row["fwd_timed_by"] = per_call_ms(
                    [lambda: flash_attn_kernel(q, k, v, causal=causal)],
                    FA_BWD_ITERS, "flash_attn_kernel")
                row["fwd_bounds"] = f32_bounds(
                    2 * (q.numel() + k.numel()) * 4, f_flops)
                design += (f"; the forward {row['fwd_ms']:.4f} ms "
                           f"({row['fwd_timed_by']}), "
                           f"{bounds_text(row['fwd_bounds'])}")
            rows.append(row)
            log(f"phase 12: flash_attn_bwd at {shape} {str(dt)[6:]}: "
                f"{ms:.4f} ms ({how}; {call_ms:.4f} ms with launch cost) = "
                f"{flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.3f} ms; "
                f"scaled_dot_product_attention's backward {library_ms:.4f} "
                f"ms; bound {b_ms:.5f} ms ({b_by}: {n_bytes / 1e9:.3f} GB, "
                f"{flops / 1e9:.1f} GFLOP){design}")
    return rows


def first_step_check(cfg, params, batch, tag):
    """One step's loss and gradient global norm through the kernels and
    through the plain attention (forward and backward) on the card, at
    the bf16 bar; the kernels' launches of the kernel step: forward and
    remat recompute per layer, one backward per layer.  Returns (loss,
    grad norm, the router's gradient norm for a MoE model)."""
    for fn in COUNTERS.values():
        fn.launches = 0
    loss, grads = value_and_grad(train_cli.lm_loss_fn(cfg), params, batch)
    norm = global_norm(grads)
    launched = launch_counts()
    router = (grads["layers"]["router"] if cfg.moe is not None else None)
    if router is not None:
        if router.dtype != torch.float32 or not bool(
                torch.isfinite(router).all()) or not router.abs().sum() > 0:
            raise AssertionError(f"{tag}: the router's gradient "
                                 f"{router.dtype} is not a finite nonzero "
                                 f"float32 tensor")
        router = router.norm().item()
    del grads
    p_loss, p_grads = value_and_grad(
        train_cli.lm_loss_fn(cfg, flash_attention_plain), params, batch)
    p_norm = global_norm(p_grads)
    del p_grads
    got = torch.stack([loss, norm]).cpu().numpy()
    want = torch.stack([p_loss, p_norm]).cpu().numpy()
    np.testing.assert_allclose(got, want, **BF16_TOL,
                               err_msg=f"{tag}: kernel vs plain step")
    if not np.isfinite(got).all():
        raise AssertionError(f"{tag}: the first step is not finite")
    want_launches = {"flash_attn": 2 * cfg.n_layers,
                     "flash_attn_bwd": cfg.n_layers}
    if {n: launched[n] for n in want_launches} != want_launches:
        raise AssertionError(f"{tag}: a step launched {launched}, expected "
                             f"{want_launches}")
    log(f"{tag}: the first step through the kernels == through the plain "
        f"attention at 2e-2: loss {got[0]:.6f} / {want[0]:.6f}, gradient "
        f"norm {got[1]:.6f} / {want[1]:.6f}; launches {want_launches}"
        + (f"; the float32 router's gradient norm {router:.4g}"
           if router is not None else ""))
    return float(got[0]), float(got[1]), router


def matmul_params(cfg) -> int:
    """Parameters that take part in a matrix product per token (every
    layer weight but the norms and, for MoE, the routed experts' share
    actually used, and the unembedding; not the embedding gather)."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    if cfg.moe is None:
        ffn = 3 * d * cfg.d_ff
    else:
        ffn = d * cfg.moe.n_experts + 3 * d * cfg.moe.d_expert * (
            cfg.moe.top_k + cfg.moe.n_shared_experts)
    return cfg.n_layers * (attn + ffn) + d * cfg.vocab_size


def train_stablelm(seed, dev):
    """stablelm-1.6b at full width: the first step held against the plain
    attention, then ``train_lm(smoke=False)`` for TRAIN_LM_STEPS steps
    with launches, step times, tokens/s, MFU, busy share and peak
    memory."""
    cuda = dev.type == "cuda"
    cfg = train_lm_config(TRAIN_LM_ARCH)
    n_b, n_s = train_cli.LM_BATCH[False]
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    n_params, n_bytes = param_count(params)
    if n_params != cfg.n_params:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.n_params}")
    batch = train_cli.lm_batches(cfg.vocab_size, n_b, n_s, seed, dev)(0)
    loss0, norm0, _ = first_step_check(cfg, params, batch, "phase 12")
    del params, batch
    torch.cuda.empty_cache()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = train_cli.train_lm(TRAIN_LM_ARCH, TRAIN_LM_STEPS, None, smoke=False,
                             device=dev, seed=seed, verbose=False)
    wall = time.perf_counter() - t0
    launched = launch_counts()
    per_step = {n: launched[n] / TRAIN_LM_STEPS
                for n in ("flash_attn", "flash_attn_bwd")}
    if per_step != {"flash_attn": 2.0 * cfg.n_layers,
                    "flash_attn_bwd": 1.0 * cfg.n_layers}:
        raise AssertionError(f"phase 12: launches per step {per_step}")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    losses = np.array([h["loss"] for h in res.history])
    if not np.isfinite(losses).all():
        raise AssertionError(f"phase 12: losses {losses}")
    if not np.isclose(losses[0], loss0, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"phase 12: the run's first loss {losses[0]} "
                             f"!= the checked step's {loss0}")
    sec = np.array([h["sec"] for h in res.history]) * 1e3
    steady = sec[1:] if len(sec) > 1 else sec
    p50, p95 = np.percentile(steady, 50), np.percentile(steady, 95)
    tokens = n_b * n_s
    flops = 6.0 * matmul_params(cfg) * tokens + 12.0 * cfg.head_dim \
        * attention_pairs(n_b, n_s, cfg.n_heads, True) * cfg.n_layers
    mfu = flops / (p50 / 1e3) / BF16_FLOPS_PER_S
    step_fn = make_train_step(train_cli.lm_loss_fn(cfg),
                              adamw(train_cli.LM_LR))
    st = res.state
    nb = train_cli.lm_batches(cfg.vocab_size, n_b, n_s, seed, dev)
    step = lambda: step_fn(st.params, st.opt_state, st.residual,
                           nb(TRAIN_LM_STEPS))
    busy = device_busy(step, 1)
    split = kernel_split(step, 1)
    if split is not None:
        parts, rest = split
        log(f"phase 12: device ms of a training step (CUPTI): "
            + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()
                        if k not in MOE_RANGES)
            + f"; total {sum(parts.values()):.2f}; largest of the rest: "
            f"{rest}")
    log(f"phase 12: {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}): {n_params} parameters, {n_bytes} bytes; "
        f"train_lm(smoke=False) {TRAIN_LM_STEPS} steps of ({n_b}, {n_s}) in "
        f"{wall:.2f}s: loss per step "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f" (ln V = {math.log(cfg.vocab_size):.4f}); ms per step p50 "
        f"{p50:.3f} / p95 {p95:.3f} (steps 2-{TRAIN_LM_STEPS}; the first "
        f"{sec[0]:.3f}); {tokens / (p50 / 1e3):.1f} tokens/s; MFU "
        f"{mfu:.4f} ({flops:.4g} flops a step: 6 x {matmul_params(cfg)} "
        f"matmul parameters x {tokens} tokens + attention, over 989 "
        f"TFLOP/s); launches per step {per_step}; device busy "
        f"{busy['ms']:.2f} ms of a step, {busy_share(busy, p50)}, "
        f"{busy['ops']:.0f} device ops a step; peak device memory "
        f"{peak if peak is not None else 'not measured'} bytes")
    return dict(launches=launched, per_step=per_step, losses=losses,
                split_ms=split[0] if split is not None else None,
                p50_ms=p50, p95_ms=p95, first_ms=float(sec[0]),
                tokens_per_s=tokens / (p50 / 1e3), mfu=mfu,
                flops_per_step=flops, busy=busy, peak_bytes=peak,
                grad_norm0=norm0)


def train_moe(seed, dev):
    """granite-moe-3b-a800m at full width, MOE_TRAIN_LAYERS of its
    layers: the first step held against the plain attention (the MoE's
    backward, the float32 router's gradient, the aux loss), then
    MOE_TRAIN_STEPS steps of ``fit_lm``."""
    cfg = train_lm_config(MOE_ARCH, MOE_TRAIN_LAYERS)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    batch = train_cli.lm_batches(cfg.vocab_size, *MOE_TRAIN_BATCH, seed,
                                 dev)(0)
    with torch.no_grad():
        _, aux = T.forward(params, batch["tokens"], cfg)
    loss0, _, router = first_step_check(cfg, params, batch,
                                        "phase 12 [MoE]")
    res = train_cli.fit_lm(cfg, params, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS,
                           None, seed=seed, verbose=False)
    losses = [h["loss"] for h in res.history]
    if not np.isfinite(losses).all() or not np.isclose(
            losses[0], loss0, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"phase 12 [MoE]: losses {losses}, the checked "
                             f"step's {loss0}")
    ms = [h["sec"] * 1e3 for h in res.history]
    log(f"phase 12 [MoE]: {cfg.name} at full width, {MOE_TRAIN_LAYERS} of "
        f"{get_lm_config(MOE_ARCH).n_layers} layers, ({MOE_TRAIN_BATCH[0]}, "
        f"{MOE_TRAIN_BATCH[1]}): aux loss {aux.item():.6f}, losses "
        + ", ".join(f"{x:.4f}" for x in losses) + ", ms per step "
        + ", ".join(f"{x:.1f}" for x in ms))
    return dict(losses=losses, aux=aux.item(), router_grad_norm=router,
                ms=ms)


def check_resume(seed, dev):
    """A bf16 checkpoint and resume of stablelm at full width, cut to
    RESUME_LAYERS layers: RESUME_STEPS steps checkpointed at step
    RESUME_STEPS - 1 (bf16 leaves stored as ``|V2``), the last checkpoint
    deleted, a fresh run resumed from the one before: its step's loss
    has the uninterrupted run's bits."""
    cfg = train_lm_config(TRAIN_LM_ARCH, RESUME_LAYERS)
    shape = train_cli.LM_BATCH[False]
    shutil.rmtree(LM_TRAIN_DIR, ignore_errors=True)

    def run():
        params = T.init_params(cfg, torch.Generator(device=dev)
                               .manual_seed(seed), device=dev)
        return train_cli.fit_lm(cfg, params, shape, RESUME_STEPS,
                                LM_TRAIN_DIR, seed=seed, verbose=False,
                                ckpt_every=RESUME_STEPS - 1)

    t0 = time.perf_counter()
    whole = run()
    t_whole = time.perf_counter() - t0
    steps = all_steps(LM_TRAIN_DIR)
    if steps != [RESUME_STEPS - 1, RESUME_STEPS]:
        raise AssertionError(f"phase 12: checkpoints {steps}")
    arrays = os.path.join(LM_TRAIN_DIR, f"ckpt_{RESUME_STEPS - 1:010d}",
                          "arrays.npz")
    with np.load(arrays) as z:
        kinds = {z[n].dtype.str for n in ("params/embed", "opt/mu/embed")}
        n_bytes = os.path.getsize(arrays)
    if kinds != {"|V2", "<f4"}:
        raise AssertionError(f"phase 12: checkpoint leaf types {kinds}")
    shutil.rmtree(os.path.join(LM_TRAIN_DIR, f"ckpt_{RESUME_STEPS:010d}"))
    t0 = time.perf_counter()
    resumed = run()
    t_resumed = time.perf_counter() - t0
    if len(resumed.history) != 1:
        raise AssertionError(f"phase 12: the resumed run took "
                             f"{len(resumed.history)} steps")
    want, got = whole.history[-1]["loss"], resumed.history[0]["loss"]
    if got != want:
        raise AssertionError(f"phase 12: resumed step {RESUME_STEPS}'s loss "
                             f"{got!r} != {want!r}")
    log(f"phase 12: resume of {cfg.name} at {RESUME_LAYERS} layers: "
        f"{RESUME_STEPS} steps with checkpoints ({t_whole:.2f}s; "
        f"{n_bytes} bytes an arrays.npz, bf16 leaves as |V2), the step "
        f"{RESUME_STEPS} checkpoint deleted, resumed from step "
        f"{RESUME_STEPS - 1} ({t_resumed:.2f}s): step {RESUME_STEPS}'s loss "
        f"{got!r} == the uninterrupted run's, bitwise")
    shutil.rmtree(LM_TRAIN_DIR, ignore_errors=True)
    return dict(loss=got, ckpt_bytes=n_bytes)


def phase12(seed: int, dev):
    """LM training on the card (module doc).  Returns the backward
    kernel's row of the ``kernels`` line and the phase's numbers."""
    t_phase = time.perf_counter()
    errs = check_flash_attn_bwd(seed, dev)
    timing = time_flash_attn_bwd(seed, dev)
    lm = train_stablelm(seed, dev)
    torch.cuda.empty_cache()
    moe = train_moe(seed, dev)
    torch.cuda.empty_cache()
    resume = check_resume(seed, dev)
    first = FA_BWD_SHAPES[0]
    bf16, f32 = timing[0], timing[1]
    row = dict(name="flash_attn_bwd", route="cuda",
               source=KERNEL_SOURCE.format("flash_attn", "flash_attn_bwd"),
               replaces=TPU_KERNELS["flash_attn_bwd"],
               replaces_note="no TPU kernel: the JAX package takes this "
                             "gradient with jax.grad of gqa_attention",
               shape=list(first), launches=lm["launches"]["flash_attn_bwd"],
               launches_per_step=lm["per_step"]["flash_attn_bwd"],
               max_abs_err=errs[first][torch.bfloat16][0],
               mirror_max_abs_err=errs[first][torch.bfloat16][2],
               f32_max_abs_err=errs[first][torch.float32][0],
               ms=bf16["ms"], timed_by=bf16["timed_by"],
               call_ms=bf16["call_ms"], plain_ms=bf16["plain_ms"],
               bound_ms=bf16["bound_ms"], bound_by=bf16["bound_by"],
               design_bound_ms=bf16["design_bound_ms"],
               library_ms=bf16["library_ms"], f32_ms=f32["ms"],
               f32_plain_ms=f32["plain_ms"],
               f32_library_ms=f32["library_ms"],
               f32_bound_ms=f32["bound_ms"], f32_bound_by=f32["bound_by"],
               f32_fma_bound_ms=f32["fma_bound_ms"],
               by_shape=[r for r in timing if r["dtype"] == "bfloat16"],
               f32_lm_build_shape=timing[-1])
    log(f"phase 12: {time.perf_counter() - t_phase:.1f}s")
    return dict(row=row, lm=lm, moe=moe, resume=resume)


# ---------------------------------------------------------------------------
# phase 13: the recsys models and MACE on the card
# ---------------------------------------------------------------------------

RECSYS_ARCHS = ("autoint", "dlrm-mlperf", "sasrec", "bert4rec")
# (B, S, Hq, Hkv, hd, causal) of BERT4Rec's attention at its paper's
# training batch: 2 heads of 32, full attention, S = 200 (a tail of 8 keys
# past three 64-key tiles)
B4R_FA_SHAPE = (256, 200, 2, 2, 32, False)
# rows of a training batch: configs/base.py's train_batch for the CTR
# models; BERT4Rec's and SASRec's papers' batches of sequences
RECSYS_TRAIN_BATCH = {"autoint": 65536, "dlrm-mlperf": 65536,
                      "sasrec": 128, "bert4rec": 256}
RECSYS_TRAIN_STEPS = 8
RECSYS_SHAPES_SERVED = ("serve_p99", "retrieval_cand")
RECSYS_SERVE_CALLS = 20
# candidates per forward of a CTR model at retrieval_cand: an unchunked
# AutoInt forward over 1,000,000 candidates holds ~70 GB of activations
RECSYS_CHECK_ROWS = 256      # serving rows also computed on the CPU
MACE_SHAPE = "molecule"      # configs/base.py GNN_SHAPES: 128 x 30 x 64
MACE_STEPS = 8
EQUI_TOL = 1e-4              # tests/test_models_smoke.py's property
# MACE's float32 step against its float64 step, relative to each
# gradient's norm: at the molecule batch the CPU's own float32 step lies
# up to 1.8e-4 from its float64 one (close atoms make forces and their
# gradients reach 6e8), so the card is held to the CPU in float64 at
# rtol 1e-4 / atol 1e-5 and its float32 step to the float64 one here
MACE_F32_REL = 1e-3
LIBRARY_WARMUP = 3           # calls before a library yardstick is timed
RECSYS_CLI = tuple((["--workload", "recsys", "--arch", a], a)
                   for a in RECSYS_ARCHS) + ((["--workload", "gnn"], "gnn"),)
RECSYS_CLI_STEPS = (2, 4)    # a checkpoint at 2, resumed for 3 and 4
RECSYS_DIR = os.path.join(REPO, "build", "chip_smoke_recsys")


def recsys_config(arch: str):
    """The published config; DLRM's tables cut to the reference's smoke
    cut (each vocab at most 100): Criteo-1TB's 187,767,399 rows x 128 are
    96.1 GB in float32, more than the card holds before Adam's state."""
    cfg = get_bundle(arch).config
    if arch == "dlrm-mlperf":
        cfg = dataclasses.replace(cfg, vocab_sizes=configs_smoke(
            arch).vocab_sizes)
    return cfg


def mace_config():
    return get_bundle("mace").config


def served_shape(arch: str, name: str):
    return get_bundle(arch).shape(name)


def mace_dims():
    """(graphs, atoms, edges each) of MACE_SHAPE."""
    shape = get_bundle("mace").shape(MACE_SHAPE)
    return shape.n_graphs, shape.n_nodes, shape.n_edges


def fixed_warmup(fn, n: int = LIBRARY_WARMUP):
    for _ in range(n):
        fn()
    torch.cuda.synchronize()


def check_b4r_attention(seed, dev):
    """flash_attn forward and backward, float32, at BERT4Rec's shape
    against their plain versions on the card (rtol 1e-4 / atol 1e-5),
    from the forward kernel's o and lse; two launches bitwise.  Returns
    (forward max |diff|, backward max |diff| over dQ, dK, dV)."""
    b, s, hq, hkv, hd, causal = B4R_FA_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    q, k, v = qkv((b, s, hq, hkv, hd), torch.float32, g, dev)
    do = torch.randn(b, s, hq, hd, generator=g, device=dev)
    o, lse = flash_attn_kernel(q, k, v, causal=causal, return_lse=True)
    o2 = flash_attn_kernel(q, k, v, causal=causal)
    want_o, want_lse = flash_attn_plain(q, k, v, causal=causal,
                                        return_lse=True)
    torch.cuda.synchronize()
    if not torch.equal(o, o2):
        raise AssertionError("phase 13: flash_attn's o with lse != without")
    torch.testing.assert_close(o, want_o, **FA_F32_TOL)
    torch.testing.assert_close(lse, want_lse, **FA_F32_TOL)
    got = flash_attn_bwd_kernel(q, k, v, o, do, lse, causal=causal)
    again = flash_attn_bwd_kernel(q, k, v, o, do, lse, causal=causal)
    want = flash_attn_bwd_plain(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(a, a2):
            raise AssertionError(f"phase 13: flash_attn_bwd's {name} "
                                 f"differs between two launches")
        torch.testing.assert_close(a, w, **FA_F32_TOL, msg=name)
    fwd = (o - want_o).abs().max().item()
    bwd = max((a - w).abs().max().item() for a, w in zip(got, want))
    # the distance from the plain mirror of the kernels' split TF32
    m_fwd = (o - flash_attn_plain(q, k, v, causal=causal,
                                  tf32_parts=True)).abs().max().item()
    m_bwd = max((a - w).abs().max().item() for a, w in zip(
        got, flash_attn_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                  tf32_parts=True)))
    log(f"phase 13: flash_attn and flash_attn_bwd float32 at BERT4Rec's "
        f"{B4R_FA_SHAPE} == plain at rtol 1e-4/atol 1e-5: forward max "
        f"|diff| {fwd:.3g}, backward {bwd:.3g} (from the split-TF32 "
        f"mirror {m_fwd:.3g}, {m_bwd:.3g}); two launches bitwise")
    return fwd, bwd


def time_b4r_attention(seed, dev):
    """Both kernels at BERT4Rec's shape in float32: CUPTI device ms, the
    plain versions' ms, ``F.scaled_dot_product_attention`` and its
    backward (float32, TF32 off, timed after LIBRARY_WARMUP calls) and
    the bounds: q, k, v and o over 3.35 TB/s or 4 hd flops a pair
    (forward); q, k, v, o, dO and lse in, dQ, dK, dV out, or 10 hd flops
    a pair (backward); the flops over split TF32's 165 TFLOP/s (the
    kernels' float32-accurate rate) and over the FMAs' 67
    (``f32_bounds``)."""
    b, s, hq, hkv, hd, causal = B4R_FA_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed + 14)
    q, k, v = qkv((b, s, hq, hkv, hd), torch.float32, g, dev)
    do = torch.randn(b, s, hq, hd, generator=g, device=dev)
    o, lse = flash_attn_kernel(q, k, v, causal=causal, return_lse=True)
    pairs = attention_pairs(b, s, hq, causal)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd_call = lambda: flash_attn_kernel(q, k, v, causal=causal)
    ms, how, call_ms = timed([fwd_call], 50, "flash_attn_kernel")
    plain_ms = events_ms([lambda: flash_attn_plain(q, k, v,
                                                   causal=causal)], 3)
    lib = lambda: sdpa(qt, kt, vt, is_causal=causal)
    fixed_warmup(lib)
    library_ms = events_ms([lib], 50)
    f_bytes = 4 * q.numel() * 4
    f_flops = 4.0 * hd * pairs
    f_b = f32_bounds(f_bytes, f_flops)
    bwd_call = lambda: flash_attn_bwd_kernel(q, k, v, o, do, lse,
                                             causal=causal)
    bms, bhow = per_call_ms([bwd_call], 20, "flash_attn_bwd_")
    b_call_ms = events_ms([bwd_call], 20)
    b_plain_ms = events_ms([lambda: flash_attn_bwd_plain(
        q, k, v, o, do, lse, causal=causal)], 2)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    out = sdpa(qg, kg, vg, is_causal=causal)
    dot = do.transpose(1, 2)
    lib_bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), dot,
                                          retain_graph=True)
    fixed_warmup(lib_bwd)
    b_library_ms = events_ms([lib_bwd], 20)
    del out
    bb_bytes = 8 * q.numel() * 4 + lse.numel() * 4
    bb_flops = 10.0 * hd * pairs
    bb_b = f32_bounds(bb_bytes, bb_flops)
    log(f"phase 13: flash_attn float32 at {B4R_FA_SHAPE}: {ms:.4f} ms "
        f"({how}; {call_ms:.4f} ms with launch cost) = "
        f"{f_flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.3f} ms; "
        f"scaled_dot_product_attention {library_ms:.4f} ms ({LIBRARY_WARMUP} "
        f"warm-up calls); {bounds_text(f_b)} over {f_bytes / 1e6:.1f} MB, "
        f"{f_flops / 1e9:.2f} GFLOP")
    log(f"phase 13: flash_attn_bwd float32 at {B4R_FA_SHAPE}: {bms:.4f} ms "
        f"({bhow}; {b_call_ms:.4f} ms with launch cost) = "
        f"{bb_flops / bms / 1e9:.1f} TFLOP/s; plain {b_plain_ms:.3f} ms; "
        f"scaled_dot_product_attention's backward {b_library_ms:.4f} ms; "
        f"{bounds_text(bb_b)} over {bb_bytes / 1e6:.1f} MB, "
        f"{bb_flops / 1e9:.2f} GFLOP")
    return (dict(ms=ms, timed_by=how, call_ms=call_ms, plain_ms=plain_ms,
                 library_ms=library_ms, bytes=f_bytes, flops=f_flops, **f_b),
            dict(ms=bms, timed_by=bhow, call_ms=b_call_ms,
                 plain_ms=b_plain_ms, library_ms=b_library_ms,
                 bytes=bb_bytes, flops=bb_flops, **bb_b))


def tree_on(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


def peak_text(peak) -> str:
    return "not measured" if peak is None else f"{peak} bytes"


def split_of(run):
    """Device ms of one ``run`` by kernel class (``kernel_split``) as a
    dict and a line, or (None, "not measured") when the profiler records
    no kernel."""
    split = kernel_split(run, 1)
    if split is None:
        return None, "not measured"
    parts, rest = split
    return parts, (", ".join(f"{k} {v:.3f}" for k, v in parts.items()
                             if v and k not in MOE_RANGES)
                   + f"; largest of the rest: {rest}")


def head_rows(x, n: int):
    """The first ``n`` rows (or candidates) of serving inputs, on the
    CPU."""
    out = {}
    for k, v in x.items():
        cut = k in ("cand_ids", "target") or v.shape[0] > 1
        out[k] = (v[:n] if cut else v).cpu()
    return out


def serve_recsys(arch, cfg, params, seed, dev):
    """Each RECSYS_SHAPES_SERVED shape: RECSYS_SERVE_CALLS calls after two
    warm-up calls (p50 / p95 ms, host clock around a synchronised call),
    launches counted over the timed calls (zeroed just before, read just
    after), the busy share of one replayed call and the peak memory; the
    scores finite, of the expected shape, and their first
    RECSYS_CHECK_ROWS rows equal to the CPU's on the same inputs (rtol
    1e-4 / atol 1e-5)."""
    cpu_params = tree_on(params, torch.device("cpu"))
    rows = {}
    for name in RECSYS_SHAPES_SERVED:
        shape = served_shape(arch, name)
        # the serving step of launch.steps' recsys cell and its inputs
        step = launch_steps.recsys_serve_fn(cfg, shape)
        x = launch_steps.recsys_inputs(cfg, shape, seed, dev)
        want_n = shape.batch if shape.kind == "online-inference" \
            else shape.n_candidates
        with torch.no_grad():
            for _ in range(2):
                out = step(params, x)
            torch.cuda.synchronize()
            if tuple(out.shape) != (want_n,) or not bool(
                    torch.isfinite(out).all()):
                raise AssertionError(f"phase 13 [{arch} {name}]: scores "
                                     f"{tuple(out.shape)}, finite "
                                     f"{bool(torch.isfinite(out).all())}")
            cpu = step(cpu_params, head_rows(x, RECSYS_CHECK_ROWS))
            np.testing.assert_allclose(
                out[:RECSYS_CHECK_ROWS].cpu().numpy(), cpu.numpy(),
                **CPU_TRAIN_TOL, err_msg=f"phase 13 [{arch} {name}]")
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            for fn in COUNTERS.values():
                fn.launches = 0
            ms = []
            for _ in range(RECSYS_SERVE_CALLS):
                t0 = time.perf_counter()
                step(params, x)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            launched = {n: c for n, c in launch_counts().items() if c}
            peak = torch.cuda.max_memory_allocated() \
                if dev.type == "cuda" else None
            busy = device_busy(lambda: step(params, x), 1)
            split, split_line = split_of(lambda: step(params, x))
        p50, p95 = np.percentile(ms, 50), np.percentile(ms, 95)
        per_call = {n: c / RECSYS_SERVE_CALLS for n, c in launched.items()}
        want = ({"flash_attn": float(cfg.n_blocks)}
                if R.uses_flash_attn(cfg) else {})
        if per_call != want:
            raise AssertionError(f"phase 13 [{arch} {name}]: launches per "
                                 f"call {per_call}, expected {want}")
        rows[name] = dict(p50_ms=p50, p95_ms=p95, busy=busy, split_ms=split,
                          launches=launched, peak_bytes=peak)
        log(f"phase 13 [{arch} {name}]: {want_n} scores a call, first "
            f"{RECSYS_CHECK_ROWS} == the CPU's at rtol 1e-4/atol 1e-5; "
            f"p50 {p50:.3f} / p95 {p95:.3f} ms a call over "
            f"{RECSYS_SERVE_CALLS}; launches per call {per_call or 'none'}; "
            f"device busy {busy['ms']:.3f} ms a call, "
            f"{busy_share(busy, p50)}, {busy['ops']:.0f} device ops a "
            f"call; peak device memory {peak_text(peak)}; device ms of a "
            f"call (CUPTI): {split_line}")
    return rows


def grads_close(got, want, tol, what, scaled=False):
    """Every leaf of two gradient trees at ``tol``; with ``scaled`` the
    atol is relative to the leaf's largest entry (MACE's gradients reach
    ~4e3, as in tests/test_torch_mace.py).  Returns the largest |diff|."""
    worst = 0.0
    for (n, a), (_, b) in zip(flatten_with_paths(got),
                              flatten_with_paths(want)):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        top = max(float(b.abs().max()) if b.numel() else 0.0, 1.0) \
            if scaled else 1.0
        torch.testing.assert_close(a, b, rtol=tol["rtol"],
                                   atol=tol["atol"] * top,
                                   msg=f"{what}: {n}")
        worst = max(worst, (a - b).abs().max().item() if a.numel() else 0.0)
    return worst


def first_step_against(loss_fn, params, batch, other, tol, what):
    """The loss and every gradient of one step, against ``other``: (loss
    fn, params, batch) run the same step another way (the CPU, or the
    plain attention)."""
    loss, grads = value_and_grad(loss_fn, params, batch)
    o_loss, o_grads = value_and_grad(*other)
    np.testing.assert_allclose(loss.item(), o_loss.item(), **tol,
                               err_msg=f"{what}: loss")
    return loss.item(), grads_close(grads, o_grads, tol, what)


def run_steps(fit_fn, params, dev, what):
    """``fit_fn(params)`` with counts zeroed just before and read just
    after: losses, ms per step p50 / p95 (steps 2 on), launches per
    step, peak memory."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    res = fit_fn(params)
    launched = {n: c for n, c in launch_counts().items() if c}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
        else None
    losses = [h["loss"] for h in res.history]
    if not np.isfinite(losses).all():
        raise AssertionError(f"phase 13 [{what}]: losses {losses}")
    ms = np.array([h["sec"] for h in res.history]) * 1e3
    steady = ms[1:] if len(ms) > 1 else ms
    return res, dict(losses=losses, p50_ms=float(np.percentile(steady, 50)),
                     p95_ms=float(np.percentile(steady, 95)),
                     first_ms=float(ms[0]), launches=launched,
                     per_step={n: c / len(losses)
                               for n, c in launched.items()},
                     peak_bytes=peak)


def train_recsys_arch(arch, cfg, params, seed, dev):
    """RECSYS_TRAIN_STEPS steps of ``fit_recsys`` at the arch's training
    batch: the first step held against the CPU (and BERT4Rec's against
    the plain attention on the card), launches per step, the loss of
    step 1's batch before and after the run (it must fall), ms per step,
    samples/s, the busy share of one replayed step, peak memory."""
    n_b = RECSYS_TRAIN_BATCH[arch]
    batch = train_cli.recsys_batches(cfg, seed, dev, n_b)(0)
    loss_fn = train_cli.recsys_loss_fn(cfg)
    cpu = torch.device("cpu")
    loss0, cpu_err = first_step_against(
        loss_fn, params, batch,
        (train_cli.recsys_loss_fn(cfg), tree_on(params, cpu),
         tree_on(batch, cpu)), CPU_TRAIN_TOL,
        f"phase 13 [{arch}]: the card's first step vs the CPU's")
    plain_err = None
    if R.uses_flash_attn(cfg):
        _, plain_err = first_step_against(
            loss_fn, params, batch,
            (train_cli.recsys_loss_fn(cfg, flash_attention_plain), params,
             batch), CPU_TRAIN_TOL,
            f"phase 13 [{arch}]: the kernels' first step vs the plain "
            f"attention's")
    with torch.no_grad():
        before = loss_fn(params, batch).item()
    res, row = run_steps(lambda p: train_cli.fit_recsys(
        cfg, p, RECSYS_TRAIN_STEPS, None, seed=seed, batch=n_b,
        verbose=False), params, dev, arch)
    with torch.no_grad():
        after = loss_fn(res.state.params, batch).item()
    if not np.isclose(row["losses"][0], loss0, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"phase 13 [{arch}]: the run's first loss "
                             f"{row['losses'][0]} != the checked step's "
                             f"{loss0}")
    if not after < before:
        raise AssertionError(f"phase 13 [{arch}]: step 1's batch's loss "
                             f"did not fall: {before} -> {after}")
    want = ({"flash_attn": float(cfg.n_blocks),
             "flash_attn_bwd": float(cfg.n_blocks)}
            if R.uses_flash_attn(cfg) else {})
    if row["per_step"] != want:
        raise AssertionError(f"phase 13 [{arch}]: launches per step "
                             f"{row['per_step']}, expected {want}")
    step_fn = make_train_step(loss_fn, adam(train_cli.RECSYS_LR))
    st = res.state
    nb = train_cli.recsys_batches(cfg, seed, dev, n_b)
    replay = lambda: step_fn(st.params, st.opt_state, st.residual,
                             nb(RECSYS_TRAIN_STEPS))
    busy = device_busy(replay, 1)
    split, split_line = split_of(replay)
    row.update(batch=n_b, cpu_err=cpu_err, plain_err=plain_err, busy=busy,
               split_ms=split,
               loss_before=before, loss_after=after,
               samples_per_s=n_b / (row["p50_ms"] / 1e3))
    log(f"phase 13 [{arch}]: training at batch {n_b}: the first step == "
        f"the CPU's (loss {loss0:.6f}, largest gradient |diff| "
        f"{cpu_err:.3g})"
        + (f", == the plain attention's (largest |diff| {plain_err:.3g})"
           if plain_err is not None else "")
        + f"; {RECSYS_TRAIN_STEPS} steps: loss per step "
        + ", ".join(f"{x:.4f}" for x in row["losses"])
        + f"; step 1's batch {before:.4f} -> {after:.4f}; ms per step p50 "
        f"{row['p50_ms']:.3f} / p95 {row['p95_ms']:.3f} (the first "
        f"{row['first_ms']:.1f}); {row['samples_per_s']:.1f} samples/s; "
        f"launches per step {row['per_step'] or 'none'}; device busy "
        f"{busy['ms']:.3f} ms a step, {busy_share(busy, row['p50_ms'])}, "
        f"{busy['ops']:.0f} device ops a step; peak device memory "
        f"{peak_text(row['peak_bytes'])}; device ms of a step (CUPTI): "
        f"{split_line}")
    return row


def recsys_phase(seed, dev):
    """Each arch: weights drawn on the card from ``seed``, serving, then
    training (module doc)."""
    out = {}
    for arch in RECSYS_ARCHS:
        cfg = recsys_config(arch)
        params = train_cli.recsys_init(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        n_params = sum(t.numel() for t in tree_leaves(params))
        log(f"phase 13 [{arch}]: {cfg.name} ({cfg.family}, embed_dim "
            f"{cfg.embed_dim}, {cfg.source}): {n_params} parameters"
            + (f"; tables cut to vocabs <= 100 (Criteo-1TB's "
               f"{sum(get_bundle(arch).config.vocab_sizes)} rows do not "
               f"fit)" if arch == "dlrm-mlperf" else ""))
        served = serve_recsys(arch, cfg, params, seed, dev)
        trained = train_recsys_arch(arch, cfg, params, seed, dev)
        out[arch] = dict(serve=served, train=trained, params=n_params)
        del params
        torch.cuda.empty_cache()
    return out


def mace_phase(seed, dev):
    """MACE at its published width on the ``molecule`` shape: the
    equivariance property, the first step against the CPU, MACE_STEPS
    steps of ``fit_gnn``."""
    cfg = mace_config()
    dims = mace_dims()
    params = MA.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    batch = train_cli.gnn_batches(cfg, seed, dev, dims)(0)
    inputs = {k: batch[k] for k in MA.INPUTS}
    rot = torch.from_numpy(rotation(seed)).to(dev)
    shift = torch.randn(3, generator=torch.Generator().manual_seed(seed)
                        ).to(dev)
    with torch.no_grad():
        e1, f1 = MA.energy_and_forces(params, cfg, n_graphs=dims[0],
                                      **inputs)
        e2, f2 = MA.energy_and_forces(
            params, cfg, n_graphs=dims[0],
            **dict(inputs, positions=inputs["positions"] @ rot.T + shift))
    e_err = ((e1 - e2).abs() / e1.abs().clamp(min=1.0)).max().item()
    f_err = ((f2 - f1 @ rot.T).abs().max()
             / f1.abs().max().clamp(min=1e-3)).item()
    if not (e_err < EQUI_TOL and f_err < EQUI_TOL) or not bool(
            torch.isfinite(f1).all()):
        raise AssertionError(f"phase 13 [MACE]: under a rotation the "
                             f"energies moved {e_err:.3g}, the forces "
                             f"{f_err:.3g} (bar {EQUI_TOL})")
    loss_fn = train_cli.gnn_loss_fn(cfg, dims[0])
    cpu = torch.device("cpu")
    f64 = lambda tree: tree_map(lambda t: t.double() if t.is_floating_point()
                                else t, tree)
    want_loss, want = value_and_grad(loss_fn, f64(tree_on(params, cpu)),
                                     f64(tree_on(batch, cpu)))
    got_loss, got = value_and_grad(loss_fn, f64(params), f64(batch))
    np.testing.assert_allclose(got_loss.item(), want_loss.item(),
                               **CPU_TRAIN_TOL, err_msg="phase 13 [MACE]")
    cpu_err = grads_close(got, want, CPU_TRAIN_TOL, "phase 13 [MACE]: the "
                          "card's first step vs the CPU's, float64",
                          scaled=True)
    loss0, grads = value_and_grad(loss_fn, params, batch)
    loss0 = loss0.item()
    f32_rel = max([abs(loss0 - want_loss.item()) / abs(want_loss.item())]
                  + [((a.double().cpu() - b).norm() / b.norm()).item()
                     for a, b in zip(tree_leaves(grads), tree_leaves(want))
                     if b.norm() > 0])
    if not f32_rel < MACE_F32_REL:
        raise AssertionError(f"phase 13 [MACE]: the card's float32 step is "
                             f"{f32_rel:.3g} from the float64 step (bar "
                             f"{MACE_F32_REL})")
    del got, want, grads
    with torch.no_grad():
        before = loss_fn(params, batch).item()
    res, row = run_steps(lambda p: train_cli.fit_gnn(
        cfg, p, MACE_STEPS, None, seed=seed, shape=dims, verbose=False),
        params, dev, "MACE")
    with torch.no_grad():
        after = loss_fn(res.state.params, batch).item()
    if not np.isclose(row["losses"][0], loss0, rtol=1e-5, atol=1e-6) \
            or not after < before:
        raise AssertionError(f"phase 13 [MACE]: first loss {row['losses'][0]}"
                             f" (checked {loss0}); step 1's batch {before} "
                             f"-> {after}")
    step_fn = make_train_step(loss_fn, adam(train_cli.GNN_LR))
    st = res.state
    nb = train_cli.gnn_batches(cfg, seed, dev, dims)
    replay = lambda: step_fn(st.params, st.opt_state, st.residual,
                             nb(MACE_STEPS))
    busy = device_busy(replay, 1)
    split, split_line = split_of(replay)
    row.update(equivariance=(e_err, f_err), cpu_err=cpu_err,
               f32_rel=f32_rel, busy=busy, split_ms=split,
               loss_before=before, loss_after=after)
    log(f"phase 13 [MACE]: {cfg.name} (d_hidden {cfg.d_hidden}, "
        f"correlation order {cfg.correlation_order}, {cfg.n_layers} layers) "
        f"on {MACE_SHAPE} {dims} (graphs, atoms, edges each): under a "
        f"random rotation and shift energies moved {e_err:.3g} and forces "
        f"{f_err:.3g} of their scale (bar {EQUI_TOL}); the first step in "
        f"float64 == the CPU's at rtol 1e-4/atol 1e-5 (largest gradient "
        f"|diff| {cpu_err:.3g}, atol relative to each leaf's largest "
        f"entry); in float32 (loss {loss0:.6g}) {f32_rel:.3g} of each "
        f"gradient's norm from the float64 step (bar {MACE_F32_REL}); "
        f"{MACE_STEPS} steps: loss per step "
        + ", ".join(f"{x:.6g}" for x in row["losses"])
        + f"; step 1's batch {before:.6g} -> {after:.6g}; ms per step p50 "
        f"{row['p50_ms']:.3f} / p95 {row['p95_ms']:.3f} (the first "
        f"{row['first_ms']:.1f}); device busy {busy['ms']:.3f} ms a step, "
        f"{busy_share(busy, row['p50_ms'])}, {busy['ops']:.0f} device ops "
        f"a step; peak device memory {peak_text(row['peak_bytes'])}; "
        f"device ms of a step (CUPTI): {split_line}")
    return row


def rotation(seed: int) -> np.ndarray:
    """A random proper rotation (tests/prophelpers.py's)."""
    q, _ = np.linalg.qr(np.random.RandomState(seed).randn(3, 3))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def run_recsys_cli(dev):
    """``repro_torch.launch.train.main()`` in process for each RECSYS_CLI
    workload: RECSYS_CLI_STEPS[0] steps into a checkpoint directory, then
    the CLI asked for RECSYS_CLI_STEPS[1] resumes there; an
    uninterrupted run in another directory: the resumed steps' losses and
    gradient norms have its bits.  BERT4Rec's CLI launches flash_attn."""
    argv0 = sys.argv
    rows = {}
    a, b = RECSYS_CLI_STEPS
    try:
        for flags, name in RECSYS_CLI:
            runs = []
            for steps, where in ((a, "part"), (b, "part"), (b, "whole")):
                d = os.path.join(RECSYS_DIR, name, where)
                sys.argv = ["train"] + flags + [
                    "--steps", str(steps), "--ckpt-dir", d] + (
                    ["--device", str(dev)] if dev.type != "cuda" else [])
                for fn in COUNTERS.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                runs.append((train_cli.main(), time.perf_counter() - t0,
                             {n: c for n, c in launch_counts().items()
                              if c}))
            resumed, whole = runs[1][0].history, runs[2][0].history
            if [h["step"] for h in resumed] != list(range(a + 1, b + 1)):
                raise AssertionError(f"phase 13: the {name} CLI resumed at "
                                     f"{[h['step'] for h in resumed]}")
            for key in ("loss", "grad_norm"):
                got = [h[key] for h in resumed]
                want = [h[key] for h in whole[a:]]
                if got != want:
                    raise AssertionError(f"phase 13: the {name} CLI's "
                                         f"resumed {key} {got} != the "
                                         f"uninterrupted run's {want}")
            if name == "bert4rec" and not runs[2][2].get("flash_attn"):
                raise AssertionError("phase 13: the bert4rec CLI launched "
                                     "no flash_attn")
            rows[name] = dict(wall_s=[r[1] for r in runs],
                              launches=runs[2][2],
                              losses=[h["loss"] for h in whole])
            log(f"phase 13: CLI {' '.join(flags)}: {a} steps into a "
                f"checkpoint ({runs[0][1]:.2f}s), resumed to {b} "
                f"({runs[1][1]:.2f}s): steps {a + 1}-{b}'s losses "
                + ", ".join(f"{h['loss']!r}" for h in resumed)
                + f" == the uninterrupted run's ({runs[2][1]:.2f}s), "
                f"bitwise, gradient norms too; launches of {b} steps "
                f"{runs[2][2] or 'none'}")
    finally:
        sys.argv = argv0
        shutil.rmtree(RECSYS_DIR, ignore_errors=True)
    return rows


def phase13(seed: int, dev):
    """The recsys models and MACE on the card (module doc).  Returns the
    two rows of the ``kernels`` line at BERT4Rec's shape and the phase's
    numbers."""
    t_phase = time.perf_counter()
    fwd_err, bwd_err = check_b4r_attention(seed, dev)
    fwd, bwd = time_b4r_attention(seed, dev)
    recsys = recsys_phase(seed, dev)
    mace = mace_phase(seed, dev)
    torch.cuda.empty_cache()
    cli = run_recsys_cli(dev)
    b4r = recsys["bert4rec"]
    served = sum(r["launches"].get("flash_attn", 0)
                 for r in b4r["serve"].values())
    trained = b4r["train"]["launches"]
    if served == 0 or not trained.get("flash_attn") \
            or not trained.get("flash_attn_bwd"):
        raise AssertionError("phase 13: BERT4Rec's main path launched no "
                             "flash_attn or flash_attn_bwd")
    if any(r["launches"].get("flash_attn") or r["launches"].get(
            "flash_attn_bwd") for a in ("sasrec", "autoint", "dlrm-mlperf")
           for r in list(recsys[a]["serve"].values()) + [recsys[a]["train"]]):
        raise AssertionError("phase 13: a model without a kernel head dim "
                             "launched flash_attn")
    note = ("float32, non-causal, BERT4Rec's training batch; launches: "
            "its serving calls and training steps in phase 13")
    rows = [dict(name="flash_attn_bert4rec", route="cuda",
                 source=KERNEL_SOURCE.format("flash_attn", "flash_attn"),
                 replaces=TPU_KERNELS["flash_attn"], shape=list(B4R_FA_SHAPE),
                 launches=served + trained["flash_attn"],
                 launches_by_path=dict(serve=served,
                                       train=trained["flash_attn"]),
                 launches_per_step=b4r["train"]["per_step"]["flash_attn"],
                 max_abs_err=fwd_err, note=note, **fwd),
            dict(name="flash_attn_bwd_bert4rec", route="cuda",
                 source=KERNEL_SOURCE.format("flash_attn", "flash_attn_bwd"),
                 replaces=TPU_KERNELS["flash_attn_bwd"],
                 shape=list(B4R_FA_SHAPE),
                 launches=trained["flash_attn_bwd"],
                 launches_per_step=b4r["train"]["per_step"]["flash_attn_bwd"],
                 max_abs_err=bwd_err, note=note, **bwd)]
    log(f"phase 13: {time.perf_counter() - t_phase:.1f}s")
    return dict(rows=rows, recsys=recsys, mace=mace, cli=cli)


# phase 14, the launch tools: every cell counted on the meta device, the
# cells that one card holds stepped through launch.dryrun.run_cell
LAUNCH_STEPPED = (("seine", "index_build"), ("bert4rec", "serve_p99"),
                  ("mace", "molecule"), ("stablelm-1.6b", "prefill_32k"),
                  ("stablelm-1.6b", "train_4k"))
# steps a cell runs on the card (the last one timed); the LM cells' one
# step (20 s and 55 s; the first prefill took 0.7% longer than the second)
LAUNCH_REPEATS = {("stablelm-1.6b", "prefill_32k"): 1,
                  ("stablelm-1.6b", "train_4k"): 1}
LAUNCH_KERNELS = ("flash_attn", "flash_attn_bwd", "seg_interact", "embed_bag",
                  "csr_lookup", "knrm_pool")
LAUNCH_JOBS = max(1, min(8, (os.cpu_count() or 2) - 1))
# seine/retrieve's step on phase 1's index (its own 144 GB index does not
# fit): 8 query terms, the hot head and 4 Zipfian draws, x 16,384 docs
RETRIEVE_TERMS = 8
RETRIEVE_CANDS = 16384
# flash_attn at stablelm's prefill_32k: (B, S, Hq, Hkv, hd) bf16 causal;
# the plain version (131,328 tile steps a slice at S = 32,768, ~50 s on
# the card) checks the last batch row's last head, the highest offsets
PREFILL_ATTN_SHAPE = (32, 32768, 32, 32, 64)


def check_prefill_attention(seed, dev):
    """The bf16 kernel over the whole prefill_32k shape (2^31 elements a
    tensor: 64-bit offsets) against its plain version on the last batch
    row's last head, at the bf16 bar.  Returns the largest |diff|."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = qkv(PREFILL_ATTN_SHAPE, torch.bfloat16, g, dev)
    t0 = time.perf_counter()
    out = flash_attn_kernel(q, k, v, causal=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    sl = lambda t: t[-1:, :, -1:].contiguous()
    want = flash_attn_plain(sl(q), sl(k), sl(v), causal=True).float()
    got = sl(out).float()
    torch.testing.assert_close(got, want, **BF16_TOL)
    err = (got - want).abs().max().item()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("phase 14: flash_attn at prefill_32k's shape "
                             "gave non-finite values")
    log(f"phase 14: flash_attn at {PREFILL_ATTN_SHAPE} bf16 causal "
        f"({q.numel():,} elements a tensor) in {ms:.1f} ms (host clock, "
        f"first call) == plain on the last batch row's last head: max "
        f"|diff| {err:.3g} (bar 2e-2 + 2e-2 |plain|)")
    return err


def retrieve_inputs(seed, dev):
    """Phase 1's index, KNRM's weights and a query of RETRIEVE_TERMS
    terms against RETRIEVE_CANDS distinct docs, from ``seed``."""
    index, rng = build_index(seed, dev)
    q = np.concatenate([np.arange(N_HOT), rng.choice(
        np.arange(N_HOT, VOCAB), RETRIEVE_TERMS - N_HOT, replace=False,
        p=zipf_p(VOCAB)[N_HOT:] / zipf_p(VOCAB)[N_HOT:].sum())])
    docs = np.sort(rng.choice(N_DOCS, min(RETRIEVE_CANDS, N_DOCS),
                              replace=False))
    params = get_retriever("knrm").init(torch.Generator().manual_seed(seed),
                                        N_B, index.functions, device=dev)
    as_ids = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
    return index, params, as_ids(q), as_ids(docs)


def log_stepped(arch, shape, rec):
    rl, mem = rec["roofline"], rec["memory"]
    peak = ("not measured" if mem["peak_gib_per_device"] is None
            else f"{mem['peak_gib_per_device'] * 2**30 / 1e9:.2f} GB")
    log(f"phase 14 [{arch}/{shape}]: peak {peak}, step "
        f"{rec['step_s']:.4f} s (first {rec['compile_s']:.4f} s), "
        f"flops {rl['flops_per_device']:.4g}, eager bytes "
        f"{rl['hbm_bytes_per_device']:.4g}, t_compute "
        f"{rl['t_compute_s']:.4g} s, t_bound {rl['t_bound_s']:.4g} s "
        f"({rl['bottleneck']}), t_compute / step "
        f"{rl['t_compute_s'] / rec['step_s']:.4f}, t_bound / step "
        f"{rec['roofline_share']:.4f}")


def phase14(seed, dev):
    """The launch tools (module doc).  Returns the launches of the
    stepped path by kernel and the records."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    counted = launch_dryrun.count_cells(launch_steps.all_cell_ids(),
                                        jobs=LAUNCH_JOBS)
    log(f"phase 14: counting pass {time.perf_counter() - t0:.1f}s "
        f"({LAUNCH_JOBS} processes)")
    log(f"phase 14: counted {len(counted)} cells on the meta device "
        f"(flops of the matrix products, bytes of eager traffic; "
        f"attention through gqa_attention at chunk 1,024)")
    for line in launch_report.roofline_table(
            list(counted.values()), "card").splitlines()[2:]:
        log(f"phase 14: {line}")
    attn_err = check_prefill_attention(seed, dev)
    torch.cuda.empty_cache()
    retrieve = launch_steps.build_cell("seine", "retrieve")

    for fn in COUNTERS.values():
        fn.launches = 0
    stepped = {}
    for arch, shape in LAUNCH_STEPPED:
        rec = launch_dryrun.run_cell(
            arch, shape, device=dev, seed=seed, verbose=False,
            repeats=LAUNCH_REPEATS.get((arch, shape), 2),
            counted=counted[(arch, shape)])
        if rec["step_s"] is None:
            raise AssertionError(f"phase 14 [{arch}/{shape}]: not stepped: "
                                 f"{rec['on_card_reason']}")
        stepped[(arch, shape)] = rec
        log_stepped(arch, shape, rec)
        torch.cuda.empty_cache()
    # phase 1's index (7 GB) only after the LM cells have left the card;
    # its build launches no kernel
    index, kparams, q, docs = retrieve_inputs(seed, dev)
    with torch.no_grad():
        scores = retrieve.fn(index, kparams, q, docs)
    torch.cuda.synchronize()
    launched = launch_counts()

    want = SeineEngine(index, "knrm", kparams).score(q, docs)
    assert_equal(scores, want, "phase 14: seine/retrieve's step against "
                 "SeineEngine.score")
    if tuple(scores.shape) != (docs.shape[0],) or not bool(
            torch.isfinite(scores).all()):
        raise AssertionError("phase 14: seine/retrieve's scores")
    missing = [k for k in LAUNCH_KERNELS if not launched.get(k)]
    if missing:
        raise AssertionError(f"phase 14: {missing} never launched through "
                             f"launch.steps ({launched})")
    log(f"phase 14: seine/retrieve's step on phase 1's index, "
        f"{q.shape[0]} terms x {docs.shape[0]} docs == SeineEngine.score "
        f"bitwise; launches through launch.steps "
        f"{ {k: v for k, v in launched.items() if v} }")
    del index
    log(f"phase 14: {time.perf_counter() - t_phase:.1f}s")
    return dict(launches=launched, stepped=stepped, counted=counted,
                attn_err=attn_err)


# ---------------------------------------------------------------------------
# phase 15: the serving half of the mesh paths on a 1 x 1 NCCL mesh
# ---------------------------------------------------------------------------

MESH_BUILD_DOCS = 2_048     # phase 5's first docs, built with and without
MESH_DIR = os.path.join(REPO, "build", "chip_smoke_mesh")
MESH_COUNTERS = {"all_reduce": all_reduce_sum,
                 "all_gather": all_gather_stack,
                 "all_gather_rows": all_gather_rows,
                 "reduce_scatter_rows": reduce_scatter_rows}


def mesh_counts():
    return dict(launch_counts(), **{n: fn.launches
                                    for n, fn in MESH_COUNTERS.items()})


def zero_counts():
    for fn in list(COUNTERS.values()) + list(MESH_COUNTERS.values()):
        fn.launches = 0


def nccl_kernels(run) -> dict:
    """Device ms of each NCCL entry the profiler records while ``run``
    runs (0 where it records no device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
            if "nccl" in e.key.lower()}


def mesh_serving(ctx, seed, dev, mesh, card):
    """Phase 1's index served on the mesh three ways, each bitwise phase
    3's mesh-less scores; the meshed and mesh-less p50 per request."""
    spec = get_retriever("knrm")
    params = spec.init(torch.Generator().manual_seed(seed), N_B,
                       ctx["index"].functions, device=dev)
    requests, want = ctx["requests"], ctx["scores"]
    out = {}
    for path, index, kw in (
            ("single CSR", ctx["index"], {}),
            (f"K={K_SHARDS}", ctx["pidx"], {}),
            ("term, K from the mesh", ctx["index"],
             dict(partition="term"))):
        t0 = time.perf_counter()
        engine = SeineEngine(index, "knrm", params, mesh=mesh, **kw)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        serve_batches(engine, requests[:1])         # warm-up
        zero_counts()
        scores, stats = serve_batches(engine, requests)
        launched = mesh_counts()
        for i, (got, w) in enumerate(zip(scores, want)):
            if not np.array_equal(got, w):
                raise AssertionError(
                    f"phase 15 [{path}]: request {i}'s meshed scores differ "
                    f"from phase 3's (max |diff| "
                    f"{np.abs(got - w).max():.3g})")
        for name in ("csr_lookup", "knrm_pool", "all_reduce", "all_gather"):
            if launched[name] < N_REQUESTS:
                raise AssertionError(f"phase 15 [{path}]: {name} launched "
                                     f"{launched[name]} times for "
                                     f"{N_REQUESTS} requests")
        # the same device arrays served mesh-less: the placement holds all
        # of them on a 1 x 1 mesh
        meshless = SeineEngine(dataclasses.replace(engine.index,
                                                   placement=None),
                               "knrm", params)
        serve_batches(meshless, requests[:1])
        plain, pstats = serve_batches(meshless, requests)
        if not all(np.array_equal(a, b) for a, b in zip(plain, want)):
            raise AssertionError(f"phase 15 [{path}]: mesh-less scores "
                                 "differ from phase 3's")
        pl = engine.index.placement
        k = getattr(engine.index, "n_shards", 1)
        log(f"phase 15 [{path}]: placed K={k} rows/shards [{pl.lo}, "
            f"{pl.hi}) over {pl.axes} in "
            f"{place_s:.2f}s; {N_REQUESTS} requests == phase 3's mesh-less "
            f"scores bitwise; launches {launched}")
        log(f"phase 15 [{path}] ({card}): p50 per request meshed "
            f"{stats.p50_ms:.3f} ms (p95 {stats.p95_ms:.3f}), mesh-less "
            f"{pstats.p50_ms:.3f} ms (p95 {pstats.p95_ms:.3f})")
        out[path] = dict(launches=launched, p50_ms=stats.p50_ms,
                         meshless_p50_ms=pstats.p50_ms)
        del meshless
        if path != "term, K from the mesh":
            del engine
            torch.cuda.empty_cache()
    # last, as a capture leaves the host slower for the timings after it
    # (scripts/mesh_serving_ab.py)
    nccl = nccl_kernels(lambda: serve_batches(engine, requests[:2]))
    log(f"phase 15: NCCL entries the profiler recorded over 2 meshed "
        f"requests (device ms): {nccl or 'none'}")
    del engine
    torch.cuda.empty_cache()
    return out


def mesh_build(corpus, seed, dev, mesh):
    """build_partitioned(mesh=) over phase 5's first MESH_BUILD_DOCS docs,
    bitwise the mesh-less build of the same docs."""
    cfg, _, vocab, toks, segs, _ = corpus
    n = min(MESH_BUILD_DOCS, toks.shape[0])
    provider = HashProvider(vocab.size, cfg.embed_dim,
                            generator=torch.Generator().manual_seed(seed),
                            device=dev)
    ip = init_interaction_params(torch.Generator().manual_seed(seed + 1),
                                 cfg.embed_dim, device=dev)
    builder = IndexBuilder(cfg, vocab, provider, ip=ip, device=dev)
    kw = dict(batch_size=BUILD_BATCH, max_uniq=BUILD_MAX_UNIQ)
    t0 = time.perf_counter()
    plain = builder.build_partitioned(toks[:n], segs[:n], BUILD_K, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    zero_counts()
    placed = builder.build_partitioned(toks[:n], segs[:n], BUILD_K,
                                       mesh=mesh, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launched = mesh_counts()
    for name in ("seg_interact", "embed_bag"):
        if launched[name] <= 0:
            raise AssertionError(f"phase 15: the meshed build launched no "
                                 f"{name}")
    for name in ("term_offsets", "doc_ids", "values", "fences",
                 "term_to_shard", "range_lo", "range_hi", "split_term",
                 "split_doc", "idf", "doc_len", "seg_len"):
        a, b = getattr(placed, name), getattr(plain, name)
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            raise AssertionError(f"phase 15: the meshed build's {name} "
                                 "differs from the mesh-less build's")
    log(f"phase 15: build_partitioned(mesh=) K={placed.n_shards} over "
        f"{n} docs of phase 5's corpus in {t2 - t1:.2f}s (mesh-less "
        f"{t1 - t0:.2f}s), every array bitwise the mesh-less build's; "
        f"launches {launched}")
    return dict(docs=n, launches=launched)


def mesh_decode(seed, dev, mesh):
    """sp_decode_attention at phase 10's decode-cache shape against the
    mesh-less merge of the whole cache."""
    lm = moe_config()
    n_b, n_s = DECODE_PROMPTS, DECODE_PROMPT_LEN + DECODE_STEPS
    g = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, lm.dtype)          # the cache's, bf16 at width
    k, v = (torch.randn(n_b, n_s, lm.n_kv_heads, lm.head_dim, generator=g,
                        device=dev).to(dtype) for _ in range(2))
    q = torch.randn(n_b, lm.n_heads, lm.head_dim, generator=g,
                    device=dev).to(dtype)
    lengths = (n_s - torch.arange(n_b, device=dev) * (n_s // n_b)).to(
        torch.int32)
    zero_counts()
    got = sp_decode_attention(mesh, "model")(q, k, v, lengths)
    torch.cuda.synchronize()
    gathers = all_gather_stack.launches
    valid = torch.arange(n_s, device=dev)[None] < lengths[:, None]
    want = combine_decode_stats(*(x[None] for x in local_decode_stats(
        q, k, v, valid)))
    torch.testing.assert_close(got, want, **MERGE_TOL)
    err = (got - want).abs().max().item()
    if gathers != 1:
        raise AssertionError(f"phase 15: sp_decode_attention ran {gathers} "
                             "all_gathers, not one")
    log(f"phase 15: sp_decode_attention(mesh, 'model') over the cache "
        f"{tuple(k.shape)} {k.dtype}, q {tuple(q.shape)}, lengths "
        f"{lengths.tolist()}: one all_gather, max |diff| {err:.3g} against "
        f"the mesh-less merge (bar rtol 1e-5 / atol 1e-5)")
    return err


def mesh_restore(dev, mesh):
    """Phase 9's last KNRM checkpoint restored onto the mesh, every leaf
    (a DTensor) bitwise the saved one."""
    ckpt_dir = os.path.join(MESH_DIR, "knrm")
    step = latest_step(ckpt_dir)
    with open(os.path.join(ckpt_dir, f"ckpt_{step:010d}",
                           "manifest.json")) as f:
        names = json.load(f)["names"]
    with np.load(os.path.join(ckpt_dir, f"ckpt_{step:010d}",
                              "arrays.npz")) as z:
        saved = {n: z[n] for n in names if n.startswith("params/")}
    target = {}
    for name, a in saved.items():         # the saved tree's structure
        node = target
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = torch.zeros(a.shape, device=dev)
    sh = tree_shardings(mesh, target, [(r".*", P("data"))])
    tree, manifest = restore_checkpoint(ckpt_dir, target, shardings=sh)
    n = 0
    for name, leaf in flatten_with_paths(tree):
        full = leaf.full_tensor().cpu().numpy()
        if not np.array_equal(full, saved[name]):
            raise AssertionError(f"phase 15: restored {name} differs from "
                                 "the saved leaf")
        n += 1
    if n != len(saved):
        raise AssertionError(f"phase 15: restored {n} of {len(saved)} "
                             "leaves")
    log(f"phase 15: restore_checkpoint(shardings=) of phase 9's step "
        f"{manifest['step']}: {n} leaves as DTensors on the mesh, each "
        f"bitwise the saved leaf")
    return n


def phase15(ctx, seed, dev, corpus, card=""):
    """The serving half of the mesh paths on a 1 x 1 mesh (module doc)."""
    t0 = time.perf_counter()
    mesh = make_host_mesh(1, 1, device=dev)
    try:
        log(f"phase 15: {mesh} over {torch.distributed.get_backend()}")
        out = dict(serving=mesh_serving(ctx, seed, dev, mesh, card))
        out["build"] = mesh_build(corpus, seed, dev, mesh)
        out["decode_err"] = mesh_decode(seed, dev, mesh)
        out["restored"] = mesh_restore(dev, mesh)
    finally:
        release_world()
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    log(f"phase 15: wall {time.perf_counter() - t0:.1f}s")
    return out

# ---------------------------------------------------------------------------
# phase 16: the training half of the mesh paths on a 1 x 1 NCCL mesh
# ---------------------------------------------------------------------------

MESH_TRAIN_SHAPE = (16, 1024)   # phase 12's (batch, sequence)
MESH_MOE_SHAPE = (8, 1024)      # phase 12's MoE batch, at its 4 layers
MESH_TRAIN_STEPS = 3            # steps timed a strategy (the first checked)
MESH_CKPT_LAYERS = 2            # phase 12's resume cut
MESH_TRAIN_DIR = os.path.join(REPO, "build", "chip_smoke_mesh_train")
MESH_COUNT_DIR = os.path.join(REPO, "build", "chip_smoke_mesh_count")
# cells counted on a fake world of 512 ranks, (arch, shape, strategy)
MESH_COUNTS = (("stablelm-1.6b", "train_4k", "fsdp"),
               ("granite-moe-3b-a800m", "train_4k", "tp2d"),
               ("dlrm-mlperf", "train_batch", "tp2d"),
               ("mace", "ogb_products", "tp2d"),
               ("mace", "minibatch_lg", "tp2d"))
# MACE's cells stepped placed and mesh-less (configs/base.py GNN_SHAPES),
# and the collectives each rank's nodes and edges run through
MESH_MACE_SHAPES = ("molecule", "minibatch_lg")
MACE_COLLECTIVES = ("all_gather_rows", "reduce_scatter_rows", "all_reduce")
MESH_COUNT_MESH = "multi"
MESH_COUNT_TIMEOUT_S = 300


def mesh_count_records():
    """Count the MESH_COUNTS cells on a fake world of 512 ranks: one
    ``launch.dryrun --mesh multi --in-process`` process a cell, all at
    once and waited for (a fake world and the NCCL one cannot share a
    process); their records."""
    shutil.rmtree(MESH_COUNT_DIR, ignore_errors=True)
    os.makedirs(MESH_COUNT_DIR)
    rcs = launch_dryrun._spawn(
        [[(arch, shape)] for arch, shape, _ in MESH_COUNTS], MESH_COUNT_DIR,
        ["--mesh", MESH_COUNT_MESH, "--in-process"],
        extra=[["--strategy", strategy] for *_, strategy in MESH_COUNTS],
        timeout=MESH_COUNT_TIMEOUT_S)
    recs = {}
    for (arch, shape, strategy), rc in zip(MESH_COUNTS, rcs):
        path = launch_dryrun.out_path(MESH_COUNT_DIR, arch, shape,
                                      MESH_COUNT_MESH, strategy)
        if rc != 0 or not os.path.exists(path):
            err = ""
            if os.path.exists(path + ".err"):
                with open(path + ".err") as f:
                    err = f.read()[-2000:]
            raise AssertionError(f"phase 16: counting {arch}/{shape} on "
                                 f"{MESH_COUNT_MESH} failed (exit {rc}): "
                                 f"{err}")
        with open(path) as f:
            recs[(arch, shape, strategy)] = json.load(f)
    return recs


def lm_shape(shape):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig(name="train_4k", kind="training", seq_len=shape[1],
                       global_batch=shape[0])


def same_tree(got, want, what):
    """Every leaf of ``got`` (DTensors on a 1 x 1 mesh) bitwise ``want``'s."""
    for (name, a), (_, b) in zip(flatten_with_paths(got),
                                 flatten_with_paths(want), strict=True):
        a = whole(a)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs from the "
                                 f"mesh-less step's")


def step_pair(plain, placed, args, what, dev, steps=1):
    """The mesh-less and the placed step from the same arguments: their
    metrics and next states held bitwise, the placed one's launches
    counted over its step; then ``steps`` more steps of each from the
    same state, timed, with the peak memory of those."""
    cuda = dev.type == "cuda"
    p_args = placed.place(args)
    zero_counts()
    got = placed.fn(*p_args)
    torch.cuda.synchronize()
    launched = mesh_counts()
    want = plain.fn(*args)
    torch.cuda.synchronize()
    for name in want[2]:
        a, b = whole(got[2][name]), want[2][name]
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} {a.item()!r} != the "
                                 f"mesh-less step's {b.item()!r}")
    same_tree(got[0], want[0], f"{what} parameters")
    same_tree(got[1], want[1], f"{what} optimizer state")
    metrics = {k: whole(v).item() for k, v in want[2].items()}
    del got, want
    times = {}
    for tag, cell, a in (("meshed", placed, p_args),
                         ("mesh-less", plain, args)):
        ms = []
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for _ in range(steps):
            t0 = time.perf_counter()
            out = cell.fn(*a)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            del out
        times[tag] = dict(ms=ms, p50_ms=float(np.percentile(ms, 50)),
                          peak_bytes=torch.cuda.max_memory_allocated()
                          if cuda else None)
    return dict(metrics=metrics, launches=launched, times=times,
                placed_args=p_args)


def mesh_train_lm(seed, dev, mesh, card):
    """stablelm-1.6b at full width and phase 12's shape placed ``fsdp``
    and ``tp2d`` (adamw(3e-4), remat), then granite-moe at 4 layers under
    ``fsdp``: each meshed step bitwise the mesh-less one."""
    out = {}
    for arch, n_layers, shape, strategies in (
            (TRAIN_LM_ARCH, None, MESH_TRAIN_SHAPE, ("fsdp", "tp2d")),
            (MOE_ARCH, MOE_TRAIN_LAYERS, MESH_MOE_SHAPE, ("fsdp",))):
        cfg = train_lm_config(arch, n_layers)
        sh = lm_shape(shape)
        opt = adamw(3e-4)
        plain = launch_steps._lm_train_cell(cfg, sh, None, opt=opt)
        args = plain.make_args(dev, seed)
        for strategy in strategies:
            what = f"phase 16 [{arch} {strategy}]"
            placed = launch_steps._lm_train_cell(cfg, sh, mesh,
                                                 strategy=strategy, opt=opt)
            run = step_pair(plain, placed, args, what, dev,
                            steps=MESH_TRAIN_STEPS)
            per_step = {n: run["launches"][n] for n in ("flash_attn",
                                                         "flash_attn_bwd")}
            want = {"flash_attn": 2 * cfg.n_layers,
                    "flash_attn_bwd": cfg.n_layers}
            if per_step != want:
                raise AssertionError(f"{what}: launches {run['launches']}, "
                                     f"expected {want}")
            p_args = run.pop("placed_args")
            nccl = nccl_kernels(lambda: placed.fn(*p_args))
            del p_args
            tokens = shape[0] * shape[1]
            t = run["times"]
            log(f"{what}: the meshed step == the mesh-less step bitwise "
                f"(loss {run['metrics']['loss']:.6f}, grad norm "
                f"{run['metrics']['grad_norm']:.6f}, every next parameter "
                f"and moment); launches of its step {per_step}; NCCL "
                f"entries of a step (device ms): {nccl or 'none'}")
            log(f"{what} ({card}): ms a step meshed "
                + ", ".join(f"{x:.1f}" for x in t["meshed"]["ms"])
                + f" (p50 {t['meshed']['p50_ms']:.1f}, "
                f"{tokens / (t['meshed']['p50_ms'] / 1e3):.1f} tokens/s, "
                f"peak {peak_text(t['meshed']['peak_bytes'])}), mesh-less "
                + ", ".join(f"{x:.1f}" for x in t["mesh-less"]["ms"])
                + f" (p50 {t['mesh-less']['p50_ms']:.1f}, "
                f"{tokens / (t['mesh-less']['p50_ms'] / 1e3):.1f} tokens/s, "
                f"peak {peak_text(t['mesh-less']['peak_bytes'])})")
            out[(arch, strategy)] = dict(run, nccl=nccl, per_step=per_step)
            torch.cuda.empty_cache()
        del args
        torch.cuda.empty_cache()
    return out


def mace_shape(name: str):
    return get_bundle("mace").shape(name)


def mesh_train_small(seed, dev, mesh):
    """DLRM's train_batch (phase 13's table cut) and MACE's
    MESH_MACE_SHAPES placed, each bitwise its mesh-less step; MACE's
    steps each ran its three collectives."""
    from repro_torch.configs.base import ShapeConfig
    out = {}
    cells = [("dlrm-mlperf/train_batch", lambda m: launch_steps._recsys_cell(
        recsys_config("dlrm-mlperf"), ShapeConfig(
            name="train_batch", kind="training",
            batch=RECSYS_TRAIN_BATCH["dlrm-mlperf"]), m))]
    cells += [(f"mace/{name}", lambda m, name=name: launch_steps._mace_cell(
        mace_config(), mace_shape(name), m)) for name in MESH_MACE_SHAPES]
    for name, make in cells:
        plain, placed = make(None), make(mesh)
        run = step_pair(plain, placed, plain.make_args(dev, seed),
                        f"phase 16 [{name}]", dev)
        run.pop("placed_args")
        what = ""
        if name.startswith("mace/"):
            coll = {n: run["launches"][n] for n in MACE_COLLECTIVES}
            if not all(coll.values()):
                raise AssertionError(f"phase 16 [{name}]: a collective of "
                                     f"the partitioned step never ran: "
                                     f"{coll}")
            m, t = placed.meta, run["times"]
            what = (f" ({m['n_nodes']} nodes, {m['n_edges']} edges; "
                    f"collectives of its step {coll}; peak meshed "
                    f"{peak_text(t['meshed']['peak_bytes'])}, mesh-less "
                    f"{peak_text(t['mesh-less']['peak_bytes'])})")
        log(f"phase 16 [{name}]: the meshed step == the mesh-less step "
            f"bitwise (loss {run['metrics']['loss']:.6f}, every next "
            f"parameter and moment); ms meshed "
            f"{run['times']['meshed']['p50_ms']:.2f}, mesh-less "
            f"{run['times']['mesh-less']['p50_ms']:.2f}{what}")
        out[name] = run
        torch.cuda.empty_cache()
    return out


def mesh_retrieve(ctx, seed, dev, mesh):
    """seine/retrieve placed: phase 1's index by ``shard_index``, the
    candidates split over the batch axes, each rank's lookup through the
    ``csr_lookup`` kernel merged by ``all_reduce`` and pooled by
    ``knrm_pool``: bitwise the mesh-less cell's scores."""
    index = index_to_device(ctx["index"], dev)
    rng = np.random.RandomState(seed)
    q = np.concatenate([np.arange(N_HOT), rng.choice(
        np.arange(N_HOT, VOCAB), RETRIEVE_TERMS - N_HOT, replace=False,
        p=zipf_p(VOCAB)[N_HOT:] / zipf_p(VOCAB)[N_HOT:].sum())])
    docs = np.sort(rng.choice(N_DOCS, min(RETRIEVE_CANDS, N_DOCS),
                              replace=False))
    kparams = get_retriever("knrm").init(torch.Generator().manual_seed(seed),
                                         N_B, index.functions, device=dev)
    as_ids = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
    args = (index, kparams, as_ids(q), as_ids(docs))
    want = launch_steps.build_cell("seine", "retrieve").fn(*args)
    placed = launch_steps.build_cell("seine", "retrieve", mesh)
    p_args = placed.place(args)
    zero_counts()
    got = whole(placed.fn(*p_args))
    torch.cuda.synchronize()
    launched = mesh_counts()
    assert_equal(got, want, "phase 16: the meshed seine/retrieve step "
                 "against the mesh-less step")
    for name in ("csr_lookup", "knrm_pool", "all_reduce"):
        if launched[name] <= 0:
            raise AssertionError(f"phase 16: seine/retrieve launched no "
                                 f"{name} ({launched})")
    log(f"phase 16 [seine/retrieve]: placed ({q.shape[0]} terms x "
        f"{docs.shape[0]} docs, rows [{p_args[0].placement.lo}, "
        f"{p_args[0].placement.hi}) over {p_args[0].placement.axes}) == "
        f"the mesh-less step bitwise; launches "
        f"{ {k: v for k, v in launched.items() if v} }")
    return dict(launches=launched)


def mesh_checkpoint(seed, dev, mesh):
    """stablelm at full width cut to 2 layers, placed fsdp, one meshed
    step, its state saved (rank 0 writes whole tensors) and read back
    onto the tp2d layout (reshard-on-load): every leaf bitwise."""
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.dist.sharding import opt_state_shardings
    cfg = train_lm_config(TRAIN_LM_ARCH, MESH_CKPT_LAYERS)
    sh = lm_shape(MESH_TRAIN_SHAPE)
    placed = launch_steps._lm_train_cell(cfg, sh, mesh, strategy="fsdp",
                                         opt=adamw(3e-4))
    p, o, _ = placed.fn(*placed.place(placed.make_args(dev, seed)))
    shutil.rmtree(MESH_TRAIN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    save_checkpoint(MESH_TRAIN_DIR, 1, {"params": p, "opt": o})
    t_save = time.perf_counter() - t0
    tp = launch_steps._lm_train_cell(cfg, sh, mesh, strategy="tp2d")
    target = {"params": p, "opt": o}
    shardings = {"params": tp.in_shardings[0],
                 "opt": opt_state_shardings(mesh, o, tp.in_shardings[0])}
    t0 = time.perf_counter()
    tree, manifest = restore_checkpoint(MESH_TRAIN_DIR, target,
                                        shardings=shardings)
    t_load = time.perf_counter() - t0
    n = 0
    for (name, a), (_, b) in zip(flatten_with_paths(tree),
                                 flatten_with_paths(target), strict=True):
        if not torch.equal(whole(a), whole(b)):
            raise AssertionError(f"phase 16: restored {name} differs from "
                                 "the saved meshed state")
        n += 1
    arrays = os.path.join(MESH_TRAIN_DIR, "ckpt_0000000001", "arrays.npz")
    n_bytes = os.path.getsize(arrays)
    log(f"phase 16: the fsdp-placed {cfg.name} state at {MESH_CKPT_LAYERS} "
        f"layers saved ({n_bytes} bytes, {t_save:.2f}s) and restored onto "
        f"the tp2d layout ({t_load:.2f}s): {n} leaves bitwise, step "
        f"{manifest['step']}")
    shutil.rmtree(MESH_TRAIN_DIR, ignore_errors=True)
    return n


def log_mesh_counts(recs, card):
    out = {}
    for (arch, shape, strategy), rec in recs.items():
        rl = rec["roofline"]
        coll = {k: v for k, v in rl["coll_by_op"].items()}
        log(f"phase 16 [count {arch}/{shape} {strategy} on "
            f"{MESH_COUNT_MESH}, {rec['n_devices']} fake ranks, host of "
            f"{card}]: argument bytes a device "
            f"{rec['memory']['argument_bytes_per_device']}, flops a device "
            f"{rl['flops_per_device']:.6g}, eager bytes a device "
            f"{rl['hbm_bytes_per_device']:.6g}, collective bytes by op "
            f"{coll}, t_collective {rl['t_collective_s']:.6g} s, bottleneck "
            f"{rl['bottleneck']}, useful flops "
            f"{rec['useful_flops_ratio']}, counted in {rec['lower_s']} s")
        out[f"{arch}/{shape}/{strategy}"] = dict(
            argument_bytes=rec["memory"]["argument_bytes_per_device"],
            flops=rl["flops_per_device"],
            coll_by_op=coll, t_collective_s=rl["t_collective_s"],
            count_s=rec["lower_s"])
    return out


def phase16(ctx, seed, dev, card=""):
    """The training half of the mesh paths on a 1 x 1 mesh (module
    doc)."""
    t0 = time.perf_counter()
    mesh = make_host_mesh(1, 1, device=dev)
    try:
        log(f"phase 16: {mesh} over {torch.distributed.get_backend()}")
        out = dict(lm=mesh_train_lm(seed, dev, mesh, card))
        out["small"] = mesh_train_small(seed, dev, mesh)
        out["retrieve"] = mesh_retrieve(ctx, seed, dev, mesh)
        out["restored"] = mesh_checkpoint(seed, dev, mesh)
    finally:
        release_world()
        shutil.rmtree(MESH_TRAIN_DIR, ignore_errors=True)
    t_card = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["counts"] = log_mesh_counts(mesh_count_records(), card)
    log(f"phase 16: wall {t_card:.1f}s on the card, then "
        f"{time.perf_counter() - t1:.1f}s counting on the host")
    return out


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
        for line in ptxas_summary(report):
            log(f"  {name}: {line}")

    index, rng = build_index(args.seed, dev)
    packed, _ = build_packed(index)
    p2 = phase2(index, rng, dev)
    phase2_packed(index, packed, p2)
    requests, queries, launches = phase3(index, packed, rng, dev, args.seed)
    kernels = phase4(index, packed, requests, queries, launches, p2, dev)
    # phase 15 serves phase 1's index again, from host copies
    t0 = time.perf_counter()
    mesh_ctx = dict(index=index_to_device(index, "cpu"),
                    pidx=index_to_device(packed["none"], "cpu"),
                    requests=requests, scores=phase3.scores)
    log(f"phase 4: phase 1's index and its K={K_SHARDS} partition copied to "
        f"the host for phase 15 in {time.perf_counter() - t0:.2f}s")
    del index, packed, p2
    torch.cuda.empty_cache()
    corpus = build_corpus(args.seed)
    rows, built = phase5(args.seed, dev, corpus)
    kernels += rows
    phase7(built, args.seed, dev)
    live = phase8(built, args.seed, dev)
    trained = phase9(built, args.seed, dev)
    for row in kernels:
        if row["name"] in live["repairs"]:
            row["any_segment_count"] = live["repairs"][row["name"]]
        if row["name"] in trained["per_step"]:
            row["launches_by_path"]["train"] = \
                trained["launches"][row["name"]]
            row["train_launches_per_step"] = trained["per_step"][row["name"]]
    del built
    torch.cuda.empty_cache()
    kernels.append(phase6(args.seed, dev, corpus))
    torch.cuda.empty_cache()
    kernels.append(phase10(args.seed, dev, corpus))
    torch.cuda.empty_cache()
    phase11(args.seed, dev, corpus, trained["effectiveness"])
    torch.cuda.empty_cache()
    lm_train = phase12(args.seed, dev)
    for row in kernels:
        if row["name"] == "flash_attn":
            row["launches_by_path"]["train"] = lm_train["lm"]["launches"][
                "flash_attn"]
            row["train_launches_per_step"] = lm_train["lm"]["per_step"][
                "flash_attn"]
    kernels.append(lm_train["row"])
    torch.cuda.empty_cache()
    kernels += phase13(args.seed, dev)["rows"]
    torch.cuda.empty_cache()
    launch = phase14(args.seed, dev)
    for row in kernels:
        if row["name"] in LAUNCH_KERNELS:
            row.setdefault("launches_by_path", {})["launch"] = \
                launch["launches"][row["name"]]
    torch.cuda.empty_cache()
    meshed = phase15(mesh_ctx, args.seed, dev, corpus, card)
    torch.cuda.empty_cache()
    trained_mesh = phase16(mesh_ctx, args.seed, dev, card)
    del mesh_ctx
    for row in kernels:
        if row["name"] in ("flash_attn", "flash_attn_bwd"):
            row.setdefault("launches_by_path", {}).update({
                f"mesh train {arch} {strategy}": run["per_step"][row["name"]]
                for (arch, strategy), run in trained_mesh["lm"].items()})
        if row["name"] in ("csr_lookup", "knrm_pool"):
            row.setdefault("launches_by_path", {})["mesh retrieve"] = \
                trained_mesh["retrieve"]["launches"][row["name"]]
    for row in kernels:
        for path, run in meshed["serving"].items():
            if row["name"] in ("csr_lookup", "knrm_pool"):
                row.setdefault("launches_by_path", {})[f"mesh {path}"] = \
                    run["launches"][row["name"]]
        if row["name"] in ("seg_interact", "embed_bag"):
            row.setdefault("launches_by_path", {})["mesh build"] = \
                meshed["build"]["launches"][row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
