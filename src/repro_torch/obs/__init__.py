"""repro_torch.obs — metrics, tracing and structured logging (a copy of
``repro.obs``: the same metric names, labels and Prometheus / JSON
exposition; the port cannot import the reference, whose package loads
JAX).

Pure Python, zero deps, process-local.  Three pieces:

* :mod:`~repro_torch.obs.metrics` — counters / gauges / fixed-bucket
  histograms in a global registry (``obs.counter("name").inc()``),
  disable-able wholesale (``obs.disabled()``) for overhead-critical
  sections and A/B overhead tests;
* :mod:`~repro_torch.obs.trace` — nesting timing spans
  (``with obs.span("frontend.batch"): ...``) aggregated per name, with
  optional Chrome-trace / ``torch.profiler`` emission;
* :mod:`~repro_torch.obs.export` — Prometheus text + JSON snapshot
  exporters (``obs.write_metrics("out.prom")``, ``obs.dump()``) and a
  parser for round-trip tests; :mod:`~repro_torch.obs.log` — the
  structured stderr logger (level via ``REPRO_LOG``, JSON lines via
  ``REPRO_LOG_JSON=1``).

Instrumentation sits at the Python call boundaries (engine and serve
loops), never inside a kernel.  Found-mask / routing statistics are
*sampled* (every ``REPRO_OBS_SAMPLE``-th request, default 16) because
they cost a real device lookup.

Quick start::

    from repro_torch import obs
    obs.counter("my_events_total", "what happened").inc()
    with obs.span("my.stage"):
        ...
    print(obs.to_prometheus())          # or obs.dump("snap.json")

The port's serving path (engine, serve loops, front end, coalescer, tile
cache) records the serving families of the inventory below; the build,
partition, codec, live, train and checkpoint families are the
reference's and wait for those modules' instrumentation.

Metric inventory (all names, one table — keep this current):

===================================== ========= =============================
name                                  kind      meaning / labels
===================================== ========= =============================
seine_build_docs_total                counter   docs through stages 1-3
seine_build_batches_total             counter   device batches streamed
seine_build_runs_total                counter   posting runs produced
seine_build_runs_spilled_total        counter   runs written to spill_dir
seine_build_spill_bytes_total         counter   bytes spilled to disk
seine_build_resident_bytes            gauge     run bytes resident on host
seine_build_peak_host_bytes           gauge     peak resident run bytes
seine_build_last_run_bytes            gauge     size of newest run
seine_build_total_nnz                 gauge     postings streamed (last build)
seine_build_docs_per_s                gauge     stage 1-3 throughput
seine_merge_fan_in                    gauge     runs k-way-merged in stage 4
seine_plan_range_nnz                  gauge     planned nnz {range=i}
seine_shard_count                     gauge     shards in last partition plan
seine_shard_nnz                       gauge     per-shard postings {shard=k}
seine_shard_skew_max_ratio            gauge     widest shard / even split
seine_shard_skew_mean_ratio           gauge     mean shard / even split
seine_shard_hot_splits                gauge     doc-range sub-shard cuts
seine_codec_tile_bits_total           gauge     posting tiles {bits=w}
seine_codec_bytes_saved               gauge     posting bytes codec removed
seine_codec_shrink                    gauge     raw / packed payload bytes
seine_index_nnz                       gauge     nnz of the served index
seine_index_nbytes                    gauge     bytes of the served index
seine_engine_scores_total             counter   engine.score calls
seine_engine_retrieves_total          counter   engine.retrieve calls
seine_retrieve_requests_total         counter   serve_retrieval requests
seine_retrieve_docs_scanned_total     counter   corpus docs scanned by
                                                retrieve (n_docs per call)
seine_retrieve_last_k                 gauge     trimmed k of last retrieve
seine_serve_requests_total            counter   serve_batches requests
seine_serve_degenerate_requests_total counter   empty-candidate requests
seine_serve_latency_ms                histogram per-request serve latency
seine_serve_slots_total               counter   real candidate slots scored
seine_serve_pad_slots_total           counter   padded candidate slots
seine_serve_pad_waste_ratio           gauge     pad / (pad + real) slots
seine_frontend_requests_total         counter   requests admitted to queue
seine_frontend_batches_total          counter   batches formed and served
seine_serve_queue_wait_ms             histogram admission-to-dequeue wait
seine_serve_queue_depth               gauge     queue depth at batch form
seine_serve_slo_misses_total          counter   requests rejected past SLO
seine_coalesce_pair_slots_total       counter   pre-dedupe pair slots
seine_coalesce_distinct_pairs_total   counter   distinct pairs looked up
seine_coalesce_dedupe_ratio           gauge     distinct / submitted slots
seine_tile_cache_hits_total           counter   tiles served from cache
seine_tile_cache_misses_total         counter   tiles fetched on miss
seine_tile_cache_evictions_total      counter   tiles evicted (LRU)
seine_tile_cache_overflow_pairs_total counter   pairs spilled past budget
seine_tile_cache_size_tiles           gauge     tiles resident in cache
seine_live_docs                       gauge     docs visible in the live view
seine_live_delta_nnz                  gauge     postings in delta runs
seine_live_delta_runs                 gauge     device-resident delta runs
seine_live_tombstones                 gauge     dead doc ids (persist compact)
seine_live_generation                 gauge     base generation (compactions)
seine_live_ingest_docs_total          counter   docs inserted into the delta
seine_live_deletes_total              counter   doc ids tombstoned
seine_live_compactions_total          counter   compactions folded into base
seine_live_compaction_errors_total    counter   background compaction failures
seine_frontend_epoch_swaps_total      counter   frontend engine epoch swaps
seine_lookup_found_ratio              gauge     found-mask hit rate (sampled)
seine_lookup_found_total              counter   found pairs (sampled)
seine_lookup_pairs_sampled_total      counter   looked-up pairs (sampled)
seine_lookup_pairs_total              counter   routed pairs {shard=k} (smpl)
seine_lookup_tiles_per_shard          gauge     ceil(Nmax / posting tile)
seine_lookup_tile_dmas_per_query      gauge     tile DMAs per query (sampled)
seine_heartbeat_ranks                 gauge     ranks ever seen
seine_heartbeat_age_seconds           gauge     since last beat {rank=r}
seine_heartbeat_dead_ranks            gauge     ranks past the deadline
seine_straggler_flagged_total         counter   steps flagged slow
seine_straggler_median_step_seconds   gauge     running median step time
seine_train_steps_total               counter   optimiser steps
seine_train_loss                      gauge     most recent loss
seine_train_step_seconds              histogram per-step wall time
seine_ckpt_saves_total                counter   checkpoint publishes
seine_ckpt_write_errors_total         counter   failed (a)sync ckpt writes
seine_index_saves_total               counter   index dir publishes
seine_log_errors_total                counter   error log lines {logger=}
seine_span_seconds_total              counter   span time {span=} (exporter)
seine_span_count_total                counter   span entries {span=}
seine_span_last_seconds               gauge     last span duration {span=}
===================================== ========= =============================

Span names follow the lifecycle: ``build.stream_runs`` /
``build.stage1.uniq``..``build.stage4.merge``, ``serve.request`` /
``serve.retrieve`` / ``frontend.batch``, ``ckpt.save`` /
``ckpt.save_index``, ``train.step``, and the live-index pair
``live.ingest`` / ``live.compact`` (the background merge, so compaction
wall-time shows up in ``seine_span_seconds_total`` even though it never
blocks a query).
"""
from .export import (dump, parse_prometheus, snapshot, to_prometheus,
                     write_metrics)
from .log import get_logger, set_level
from .metrics import (REGISTRY, Counter, Gauge, Histogram, Registry,
                      counter, disabled, enabled, gauge, histogram,
                      set_enabled)
from .trace import (dump_chrome_trace, enable_chrome_trace, reset_spans,
                    span, span_stats)

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "Registry",
    "counter", "gauge", "histogram", "enabled", "disabled", "set_enabled",
    "span", "span_stats", "reset_spans", "enable_chrome_trace",
    "dump_chrome_trace", "to_prometheus", "parse_prometheus", "snapshot",
    "dump", "write_metrics", "get_logger", "set_level", "reset",
]


def reset() -> None:
    """Zero every metric and span aggregate (test isolation)."""
    REGISTRY.reset()
    reset_spans()
