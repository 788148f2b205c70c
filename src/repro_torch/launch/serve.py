"""Serving CLI: batched query retrieval over a SEINE index (port of
``repro.launch.serve``, on the card).

    PYTHONPATH=src python -m repro_torch.launch.serve --retriever knrm \
        --n-queries 32 --candidates 200 --compare-noindex

Builds the (smoke-scale) index, serves batched requests through both
engines and reports mean / p50 / p95 ms per request: the Table-1
efficiency comparison as a service.  The flags, the argument errors and
the log lines are the reference's; the corpus, the vocabulary and the
index ids come from ``--seed`` exactly as there, while the HashProvider
table and the retriever's weights are drawn from ``torch.Generator``s
seeded by ``--seed`` (random weights, so scores differ from the JAX
CLI's).  ``--partition term --shards K`` serves through the term-range
PartitionedIndex.  ``--retrieve-k K`` switches to first-stage mode: no
candidate sets; each query walks the index and returns its corpus-wide
top-K (``SeineEngine.retrieve``).

``--target-qps Q`` switches to OPEN-LOOP mode: requests arrive on a
Poisson timeline through the async ``ServingFrontend`` (admission
queue, continuous batching, optional ``--slo-ms`` load shedding) and
the report adds goodput.  ``--coalesce`` dedupes (term, doc) pairs
across the formed batch and ``--cache-tiles N`` serves hot posting tiles
from a device-resident cache; both are exact (scores bitwise equal to
the per-request path).

``--live`` serves through a mutable :class:`~repro_torch.dist.live.
LiveIndex`: the base index covers part of the corpus and a background
thread ingests the held-back docs (and with ``--live-compact``,
tombstones a few and runs a compaction) while the measured loop is
serving.  ``--metrics-out`` writes the ``obs`` snapshot.

Everything runs on the card (``--device`` defaults to CUDA, and the run
fails when there is none); ``--device cpu`` runs the kernels' plain
versions and exists for the tests.  ``--data-parallel`` (mesh serving)
is not ported and exits with an error.
"""
from __future__ import annotations

import argparse
import os
import threading
import time

import numpy as np
import torch

from .. import obs

_log = obs.get_logger("repro.launch.serve")


def _per_device_at_k(pidx) -> int:
    """Bytes one device would hold with the K shards spread over K
    devices: its 1/K slice of the stacked shard arrays plus every
    replicated table (the reference's ``per_device_nbytes``)."""
    sharded = pidx.posting_nbytes + sum(
        a.numel() * a.element_size() for a in (pidx.term_offsets,
                                                pidx.fences)
        if a is not None)
    return sharded // pidx.n_shards + (pidx.nbytes - sharded)


def _join(thread: threading.Thread, errors: list) -> None:
    """Join the live ingest thread and raise its failure, if any."""
    thread.join()
    if errors:
        raise errors[0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--retriever", default="knrm")
    ap.add_argument("--n-queries", type=int, default=16)
    ap.add_argument("--candidates", type=int, default=100)
    ap.add_argument("--compare-noindex", action="store_true")
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard the index over the host mesh and score "
                         "candidate batches data-parallel (dist.sharding)")
    ap.add_argument("--partition", choices=["none", "term"], default="none",
                    help="'term': split posting lists into nnz-balanced "
                         "term-range shards (PartitionedIndex) instead of "
                         "replicating the CSR skeleton on every device")
    ap.add_argument("--shards", type=int, default=0,
                    help="shard count for --partition term (default: the "
                         "mesh model-axis size, or 1 without a mesh)")
    ap.add_argument("--codec", choices=["none", "packed", "packed-q8"],
                    default="none",
                    help="posting compression for --partition term: "
                         "'packed' FOR/bit-packs doc ids per tile "
                         "(lossless, decoded in-kernel), 'packed-q8' also "
                         "int8-quantises values with per-term scales")
    ap.add_argument("--retrieve-k", type=int, default=0, metavar="K",
                    help="first-stage retrieval mode: ignore candidate "
                         "sets and return each query's corpus-wide top-K "
                         "docs by walking the index's posting lists "
                         "(mesh-less only; 0 = off, serve candidate "
                         "re-scoring as before)")
    ap.add_argument("--batch-pad", type=int, default=0,
                    help="pad candidate sets to multiples of this bucket "
                         "size before scoring (fixes the launch shapes "
                         "across candidate-set sizes)")
    ap.add_argument("--spill-dir", default=None,
                    help="spill per-batch posting runs to this directory "
                         "during the build (bounds resident host bytes by "
                         "one run instead of total nnz)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the obs metrics snapshot here after "
                         "serving: Prometheus text exposition, or a JSON "
                         "snapshot when the path ends in .json")
    ap.add_argument("--target-qps", type=float, default=0.0,
                    help="open-loop mode: submit requests on a Poisson "
                         "timeline at this rate through the async "
                         "ServingFrontend and report goodput alongside "
                         "latency quantiles (0 = closed-loop serve_batches "
                         "as before; mesh-less only)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="open-loop SLO: requests aged past this in the "
                         "queue are rejected unserved (counted in "
                         "seine_serve_slo_misses_total) and goodput is the "
                         "fraction served within it (0 = no SLO)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="open-loop batch size target: a forming batch "
                         "closes as soon as it holds this many requests")
    ap.add_argument("--batch-timeout-ms", type=float, default=2.0,
                    help="open-loop batch time budget: a forming batch "
                         "closes this many ms after its first request "
                         "even if below --max-batch")
    ap.add_argument("--coalesce", action="store_true",
                    help="open-loop: dedupe (term, doc) pairs shared "
                         "across the formed batch's queries — one routed "
                         "bisect + one tile fetch per DISTINCT pair, "
                         "scattered back per query (exact)")
    ap.add_argument("--cache-tiles", type=int, default=0,
                    help="open-loop: device-resident LRU cache budget in "
                         "posting tiles, serving hot tiles without "
                         "re-fetch/re-decode (requires --coalesce and "
                         "--partition term; 0 = off)")
    ap.add_argument("--live", action="store_true",
                    help="serve through a mutable LiveIndex (dist.live): "
                         "build the base from part of the corpus, ingest "
                         "the held-back docs from a background thread "
                         "WHILE the measured loop serves (LSM delta runs; "
                         "requires --partition term, mesh-less only)")
    ap.add_argument("--live-hold-frac", type=float, default=0.5,
                    metavar="FRAC",
                    help="fraction of the corpus held back from the base "
                         "build and ingested live during serving "
                         "(with --live; default 0.5)")
    ap.add_argument("--live-compact", action="store_true",
                    help="with --live: tombstone a few docs and run a "
                         "background compaction (base + frozen deltas -> "
                         "new generation, atomic epoch swap) while the "
                         "measured loop is serving")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: CUDA; 'cpu' "
                         "runs the kernels' plain versions, for the tests)")
    args = ap.parse_args()

    from ..configs import seine_smoke
    from ..core.builder import IndexBuilder
    from ..core.providers import HashProvider
    from ..core.segment import segment_corpus
    from ..core.vocab import build_vocabulary
    from ..data.batching import candidates_for_query, pad_queries
    from ..data.synth_corpus import generate
    from ..kernels.utils import resolve_device
    from ..retrievers import get_retriever
    from ..serving import (NoIndexEngine, SeineEngine, ServingFrontend,
                           run_open_loop, serve_batches, serve_retrieval)

    if args.data_parallel:
        ap.error("--data-parallel: mesh serving is not ported (mesh= "
                 "raises everywhere in the port); serve on one device")
    if args.retrieve_k < 0:
        ap.error(f"--retrieve-k must be >= 0, got {args.retrieve_k}")
    if args.codec != "none" and args.partition != "term":
        ap.error(f"--codec {args.codec} requires --partition term (the "
                 "packed layout is the stacked-shard PartitionedIndex)")
    if args.target_qps < 0:
        ap.error(f"--target-qps must be >= 0, got {args.target_qps}")
    if args.target_qps and args.retrieve_k:
        ap.error("--target-qps serves candidate re-scoring; drop "
                 "--retrieve-k")
    if args.slo_ms < 0:
        ap.error(f"--slo-ms must be >= 0, got {args.slo_ms}")
    if args.cache_tiles < 0:
        ap.error(f"--cache-tiles must be >= 0, got {args.cache_tiles}")
    if args.cache_tiles and not args.coalesce:
        ap.error("--cache-tiles requires --coalesce (the tile cache "
                 "serves the coalesced distinct-pair lookup)")
    if args.cache_tiles and args.partition != "term":
        ap.error("--cache-tiles requires --partition term (the cache "
                 "keys on the PartitionedIndex's (shard, tile) layout)")
    if (args.coalesce or args.slo_ms or args.max_batch != 8
            or args.batch_timeout_ms != 2.0) and not args.target_qps:
        ap.error("--coalesce/--cache-tiles/--slo-ms/--max-batch/"
                 "--batch-timeout-ms shape the open-loop frontend; add "
                 "--target-qps QPS to enable it")
    if args.live and args.partition != "term":
        ap.error("--live requires --partition term (the LiveIndex base "
                 "is the stacked-shard PartitionedIndex)")
    if args.live and args.compare_noindex:
        ap.error("--compare-noindex rebuilds interactions from the "
                 "static corpus; drop it with --live")
    if not 0.0 < args.live_hold_frac < 1.0 and args.live:
        ap.error("--live-hold-frac must be in (0, 1), got "
                 f"{args.live_hold_frac}")
    if (args.live_compact or args.live_hold_frac != 0.5) and not args.live:
        ap.error("--live-compact/--live-hold-frac shape the live index; "
                 "add --live to enable it")
    if args.metrics_out:
        # fail now with a clear message, not a FileNotFoundError stack
        # trace after the index build and the serving
        out_dir = os.path.dirname(os.path.abspath(args.metrics_out))
        if not os.path.isdir(out_dir):
            ap.error(f"--metrics-out directory does not exist: {out_dir}")

    dev = resolve_device(args.device)

    cfg = seine_smoke()
    ds = generate(cfg, seed=args.seed)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens)
    slot_docs = [vocab.map_tokens(d) for d in ds.docs]
    toks, segs = segment_corpus(slot_docs, cfg.n_segments, max_len=160)
    provider = HashProvider(
        vocab.size, cfg.embed_dim,
        generator=torch.Generator().manual_seed(args.seed), device=dev)
    builder = IndexBuilder(cfg, vocab, provider, device=dev)
    held = None
    if args.live:
        # live mode: base index over the leading (1 - hold_frac) of the
        # corpus; the held-back tail is ingested by a background thread
        # while the measured loop serves
        split = max(int(toks.shape[0] * (1.0 - args.live_hold_frac)), 1)
        held = (toks[split:], segs[split:])
        from ..dist.live import LiveIndex
        base = builder.build_partitioned(
            toks[:split], segs[:split], args.shards or 1, batch_size=16,
            spill_dir=args.spill_dir, codec=args.codec)
        index = LiveIndex(base, builder.pipeline, batch_size=16)
        _log.info("live index", base_docs=split,
                  held_back=toks.shape[0] - split)
    elif args.partition == "term":
        # shard-native streaming build: the index is born partitioned
        index = builder.build_partitioned(
            toks, segs, args.shards or 1, batch_size=16,
            spill_dir=args.spill_dir, codec=args.codec)
    else:
        index = builder.build(toks, segs, batch_size=16,
                              spill_dir=args.spill_dir)
    _log.info("index built", nnz=index.nnz,
              mb=f"{index.nbytes / 1e6:.1f}",
              stats=builder.last_build_stats.summary())

    queries = pad_queries(ds.queries, vocab.map_tokens, q_len=6)
    rng = np.random.RandomState(args.seed)
    n_cand = min(args.candidates, len(ds.docs))
    requests = []
    for i in range(args.n_queries):
        qi = i % len(queries)
        cands = candidates_for_query(ds.qrels[qi], rng, n_cand)
        requests.append((queries[qi], cands))

    spec = get_retriever(args.retriever)
    params = spec.init(torch.Generator().manual_seed(args.seed),
                       cfg.n_segments, index.functions, device=dev)
    engine = SeineEngine(
        index, args.retriever, params,
        partition=(None if args.partition == "none" or args.live
                   else args.partition),
        n_shards=None if args.live else (args.shards or None))
    if args.live:
        live_errors = []

        def live_mutations():
            # runs concurrently with the measured loop: chunked ingest
            # of the held-back docs, then (optionally) tombstones and a
            # compaction; a failure is raised after the join
            try:
                mutate()
            except BaseException as e:
                live_errors.append(e)

        def mutate():
            t0 = time.perf_counter()
            ht, hs = held
            chunk = max(len(ht) // 4, 1)
            for i in range(0, len(ht), chunk):
                index.insert(ht[i:i + chunk], hs[i:i + chunk],
                             batch_size=16)
            dt = time.perf_counter() - t0
            _log.info("live ingest done", docs=len(ht),
                      docs_per_s=f"{len(ht) / max(dt, 1e-9):.0f}",
                      delta_nnz=index.delta_nnz)
            if args.live_compact:
                index.delete(np.arange(min(4, index.n_docs)))
                index.compact()
                _log.info("live compaction done",
                          generation=index.generation,
                          tombstones=index.tombstones)

        ingest_thread = threading.Thread(target=live_mutations,
                                         daemon=True,
                                         name="serve-live-ingest")
    else:
        ingest_thread = None
    if args.partition == "term" and not args.live:
        pidx = engine.index
        _log.info(
            "term-partitioned (shard-native build)",
            shards=pidx.n_shards, codec=pidx.codec,
            mb_per_device=f"{pidx.nbytes / 1e6:.1f}",
            mb_per_device_at_k=f"{_per_device_at_k(pidx) / 1e6:.1f}",
            total_mb=f"{pidx.nbytes / 1e6:.1f}")
    # single-process liveness: rank 0 beats around the serve loop so the
    # heartbeat-age gauge lands in the --metrics-out snapshot
    from ..dist.fault import Heartbeat
    hb = Heartbeat()
    hb.beat(0)
    if args.retrieve_k:
        # first-stage mode: the candidate sets are ignored — each query
        # produces its own top-K from the whole corpus
        qs = [q for q, _ in requests]
        _, stats = serve_retrieval(engine, qs, args.retrieve_k)  # warm
        hb.beat(0)
        if ingest_thread is not None:
            ingest_thread.start()
        results, stats = serve_retrieval(engine, qs, args.retrieve_k)
        if ingest_thread is not None:
            _join(ingest_thread, live_errors)
        hb.beat(0)  # final beat AFTER the loop drains, so the age gauge
        #             in the snapshot reflects a live rank, not the
        #             whole measured loop's duration
        hb.dead_ranks()
        _log.info("SEINE first-stage",
                  ms_per_request=f"{stats.ms_per_request:.2f}",
                  p50=f"{stats.p50_ms:.2f}", p95=f"{stats.p95_ms:.2f}",
                  requests=args.n_queries, k=args.retrieve_k,
                  corpus=index.n_docs,
                  top1=int(results[0][1][0]) if results else -1)
        if args.metrics_out:
            obs.write_metrics(args.metrics_out)
            _log.info("metrics written", path=args.metrics_out)
        return
    if args.target_qps:
        from ..serving import ServeStats
        frontend = ServingFrontend(
            engine, max_batch=args.max_batch,
            batch_timeout_ms=args.batch_timeout_ms,
            batch_pad=args.batch_pad, slo_ms=args.slo_ms or None,
            coalesce=args.coalesce, cache_tiles=args.cache_tiles)
        # warm up off the clock (the worker's first calls build the
        # kernels and allocate), then measure on fresh stats
        for q, d in requests[:args.max_batch]:
            frontend.submit(q, d).result()
        frontend.stats = ServeStats()
        if ingest_thread is not None:
            ingest_thread.start()
        res = run_open_loop(frontend, requests,
                            target_qps=args.target_qps, seed=args.seed)
        if ingest_thread is not None:
            _join(ingest_thread, live_errors)
        frontend.close()  # drains every admitted request
        hb.beat(0)        # final beat lands AFTER the drain, so the
        #                   snapshot's age gauge reflects a live rank
        hb.dead_ranks()
        stats = res.stats
        _log.info("SEINE open-loop",
                  target_qps=args.target_qps,
                  served=res.n_served, rejected=res.n_rejected,
                  goodput=f"{res.goodput:.3f}",
                  ms_per_request=f"{stats.ms_per_request:.2f}",
                  p50=f"{stats.p50_ms:.2f}", p95=f"{stats.p95_ms:.2f}",
                  queue_ms=f"{stats.queue_ms_per_request:.2f}",
                  max_queue_depth=stats.max_queue_depth,
                  coalesce=args.coalesce, cache_tiles=args.cache_tiles)
        if args.metrics_out:
            obs.write_metrics(args.metrics_out)
            _log.info("metrics written", path=args.metrics_out)
        return
    scores, stats = serve_batches(engine, requests,
                                  batch_pad=args.batch_pad)  # warm + measure
    hb.beat(0)
    if ingest_thread is not None:
        ingest_thread.start()
    scores, stats = serve_batches(engine, requests,
                                  batch_pad=args.batch_pad)
    if ingest_thread is not None:
        _join(ingest_thread, live_errors)
    hb.beat(0)  # final beat AFTER the measured loop drains (see above)
    hb.dead_ranks()                      # records heartbeat-age gauges
    _log.info("SEINE", ms_per_request=f"{stats.ms_per_request:.2f}",
              p50=f"{stats.p50_ms:.2f}", p95=f"{stats.p95_ms:.2f}",
              requests=args.n_queries, candidates=n_cand,
              **(dict(live_docs=index.n_docs,
                      generation=index.generation) if args.live else {}))

    if args.compare_noindex:
        noidx = NoIndexEngine(builder, index, toks, segs, args.retriever,
                              params)
        _, nstats = serve_batches(noidx, requests, batch_pad=args.batch_pad)
        _, nstats = serve_batches(noidx, requests, batch_pad=args.batch_pad)
        _log.info("No-Index",
                  ms_per_request=f"{nstats.ms_per_request:.2f}",
                  p50=f"{nstats.p50_ms:.2f}", p95=f"{nstats.p95_ms:.2f}",
                  speedup=f"{nstats.ms_per_request / stats.ms_per_request:.1f}x")

    if args.metrics_out:
        obs.write_metrics(args.metrics_out)
        _log.info("metrics written", path=args.metrics_out)


if __name__ == "__main__":
    main()
