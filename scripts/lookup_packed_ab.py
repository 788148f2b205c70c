#!/usr/bin/env python3
"""Time the port's packed pair lookup (``csr_lookup_packed``, codecs
``packed`` and ``packed-q8``) on the card for one source tree, at
``chip_smoke.py``'s shapes.

    python3 scripts/lookup_packed_ab.py SRC_DIR [--seed N]
        [--cache build/scan_ab_rows.npz]

``SRC_DIR`` is the ``src`` directory of the tree to time: ``src`` for the
checkout, or that of another commit unpacked beside it (``git archive
<commit> src | tar -x -C build/parent``, then ``build/parent/src``).  To
compare two trees, run it on both in one call on one card, in turns
(parent, change, change, parent).

The index is phase 1's raw index (``scripts/retrieve_scan_ab.py`` draws
and caches its rows: 65,323 docs, n_b 20, the nine functions, 9.76M
postings; values drawn on the card from ``--seed``), split into K = 4
term-range shards and packed at tile 256 under each codec.  For each
codec it times, as device us per launch (CUPTI):

- the lookup at the serving shape, 6 slots x 1,000 candidates, over 16
  requests (3-6 real Zipfian terms each) in turn, with a warm and a cold
  L2 (64 MB overwritten before every launch);
- the lookup at the coalesced shape: one front-end batch of 8 of those
  requests, deduplicated by ``plan_coalesced`` (pairs padded to 256) and
  routed per pair, through ``index.lookup_pair_rows``: a (1, P) grid;

then the device time per re-rank of ``serve_batches`` over the 16
requests with a KNRM ``SeineEngine`` of that codec (every kernel, memcpy
and memset CUPTI records, per request, and the device ops per request).
It prints a SHA-256 digest of every M it computed (serving and coalesced
shapes) and one of the first-stage scan's lane-bounds tables
(``lane_bounds_packed_kernel``) of the 16 requests' queries over all
1,024-doc blocks; both must be equal between trees.  It prints the
card's name and power limit first and needs a CUDA device.
"""
import argparse
import hashlib
import subprocess
import sys

from lookup_pool_ab import (BATCH, N_CAND, N_REQUESTS, PAIR_PAD, Q_SLOTS,
                            cupti_us)
from retrieve_scan_ab import (BLOCK, K_SHARDS, N_B, N_DOCS, PACK_TILE,
                              VOCAB, host_rows, zipf_p)

KERNEL = "csr_lookup_packed_kernel"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", default="build/scan_ab_rows.npz")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.index import build_from_rows
    from repro_torch.data.synth_corpus import ZIPF_FUNCTIONS
    from repro_torch.dist.partition import pack_index
    from repro_torch.dist.sharding import partition_index
    from repro_torch.kernels.csr_lookup import (csr_lookup_packed_kernel,
                                                lane_bounds_packed_kernel,
                                                retrieve_lanes)
    from repro_torch.kernels.csr_lookup.ops import _route_cells
    from repro_torch.kernels.csr_lookup.ref import _lane_scale
    from repro_torch.retrievers import get_retriever
    from repro_torch.serving import SeineEngine, serve_batches
    from repro_torch.serving.coalesce import plan_coalesced

    if not torch.cuda.is_available():
        print("lookup_packed_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    doc_ids, term_ids, doc_len = host_rows(args.seed, args.cache)
    df = np.bincount(term_ids, minlength=VOCAB)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    values = torch.rand((doc_ids.size, N_B, len(ZIPF_FUNCTIONS)),
                        generator=gen, device=dev)
    index = build_from_rows(
        doc_ids, term_ids, values,
        idf=np.log(N_DOCS / np.maximum(df, 1)).astype(np.float32),
        doc_len=doc_len, seg_len=np.full((N_DOCS, N_B), 30.0, np.float32),
        n_docs=N_DOCS, vocab_size=VOCAB, functions=ZIPF_FUNCTIONS,
        device=dev)
    del values
    pidx = partition_index(index, K_SHARDS)
    del index
    rng = np.random.RandomState(args.seed + 2)
    requests = []
    for _ in range(N_REQUESTS):
        q = np.full(Q_SLOTS, -1, np.int32)
        n = rng.randint(3, Q_SLOTS + 1)
        q[:n] = rng.choice(VOCAB, size=n, replace=False, p=zipf_p(VOCAB))
        requests.append((q, rng.choice(N_DOCS, N_CAND, replace=False)
                         .astype(np.int32)))
    terms, docs, _, n_distinct = plan_coalesced(requests[:BATCH], PAIR_PAD)
    pair_t = torch.from_numpy(terms).to(dev)
    pair_d = torch.from_numpy(docs).to(dev)
    params = get_retriever("knrm").init(
        torch.Generator().manual_seed(args.seed), N_B, ZIPF_FUNCTIONS,
        device=dev)
    i32 = lambda a: a.to(torch.int32).contiguous()  # noqa: E731

    for codec in ("packed", "packed-q8"):
        p = pack_index(pidx, codec, tile=PACK_TILE)
        lookups = []
        for q, d in requests:
            q, d = torch.from_numpy(q).to(dev), torch.from_numpy(d).to(dev)
            k, lo, hi, w = _route_cells(q, d, p.term_offsets,
                                        p.term_to_shard, p.range_lo,
                                        p.split_term, p.split_doc)
            scale = (None if p.value_scale is None else
                     _lane_scale(p.value_scale, p.range_lo, k, w)
                     .contiguous())
            lookups.append((i32(k), i32(lo), i32(hi), d, p._packed(),
                            p.fences, p._serve_values, scale))
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for a in lookups:
            digest.update(csr_lookup_packed_kernel(*a, tile=PACK_TILE)
                          .cpu().numpy().tobytes())
        digest.update(p.lookup_pair_rows(pair_t, pair_d).cpu().numpy()
                      .tobytes())
        tables = hashlib.sha256()
        for q, _ in requests:
            lo, hi = retrieve_lanes(torch.from_numpy(q).to(dev),
                                    p.term_offsets, p.term_to_shard,
                                    p.range_lo, p.range_hi, p.nmax)
            tables.update(lane_bounds_packed_kernel(
                p._packed(), p.fences, p._serve_values, i32(lo), i32(hi), 0,
                BLOCK, -(-N_DOCS // BLOCK), tile=PACK_TILE).table.cpu()
                .numpy().tobytes())

        serve = [lambda a=a: csr_lookup_packed_kernel(*a, tile=PACK_TILE)
                 for a in lookups]
        warm, n_warm = cupti_us(serve, KERNEL, 160)
        cold, _ = cupti_us(serve, KERNEL, 160, cold=True)
        coal, n_coal = cupti_us([lambda: p.lookup_pair_rows(pair_t, pair_d)],
                                KERNEL, 40)

        engine = SeineEngine(p, "knrm", params, codec=codec)
        serve_batches(engine, requests[:2])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            serve_batches(engine, requests)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        rerank_ms = (sum(e.self_device_time_total for e in ev) / 1e3
                     / N_REQUESTS)
        ops = sum(e.count for e in ev) / N_REQUESTS
        print(f"[{args.src}] {codec} csr_lookup_packed {Q_SLOTS} x "
              f"{N_CAND}: {warm:.4f} us per launch warm ({n_warm} "
              f"recorded), {cold:.4f} cold; coalesced (1, "
              f"{pair_t.shape[0]}) grid of {n_distinct} distinct pairs from "
              f"{BATCH} requests: {coal:.4f} us ({n_coal} recorded); "
              f"serve_batches device time per re-rank {rerank_ms:.5f} ms "
              f"({ops:.1f} device ops); M digest {digest.hexdigest()[:16]}; "
              f"lane tables digest {tables.hexdigest()[:16]}",
              flush=True)
        del engine, p, lookups
    return 0


if __name__ == "__main__":
    sys.exit(main())
