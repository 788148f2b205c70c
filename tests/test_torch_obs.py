"""The port's copy of ``obs`` against ``repro.obs``: the same metric
operations give the same Prometheus exposition text and the same JSON
snapshot, and the serving path records only metric families of the
reference's inventory."""
import io
import json
import math
import os

import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro_torch import obs
from repro_torch.data.synth_corpus import build_zipfian_index
from repro_torch.dist.sharding import partition_index
from repro_torch.retrievers import get_retriever
from repro_torch.serving import (SeineEngine, ServingFrontend,
                                 serve_batches, serve_retrieval)
import torch_threads  # noqa: F401  (PyTorch threads per test process)


def _record(mod):
    """One sequence of metric operations on a fresh registry of ``mod``."""
    reg = mod.Registry()
    c = reg.counter("seine_serve_requests_total", "serve_batches requests")
    c.inc()
    c.inc(2.5, shard="1")
    c.inc(1, shard='we"ird\\label')
    g = reg.gauge("seine_tile_cache_size_tiles", "resident posting tiles")
    g.set(7)
    g.inc(2)
    g.dec(0.5, shard="0")
    h = reg.histogram("seine_serve_latency_ms",
                      "per-request serve latency (ms)")
    for v in (0.01, 0.3, 2.0, 2.0, 75.0, 1e6, math.inf):
        h.observe(v)
    h.observe(4.0, mode="coalesce")
    reg.histogram("seine_train_step_seconds", "per-step wall time",
                  buckets=mod.metrics.DEFAULT_S_BUCKETS).observe(0.2)
    reg.gauge("seine_index_nbytes", "bytes").set(float(1 << 40))
    reg.counter("seine_frontend_batches_total")
    return reg


def test_exposition_text_and_snapshot_match_the_reference():
    port, ref = _record(obs), _record(jax_obs)
    text = obs.to_prometheus(port, include_spans=False)
    assert text == jax_obs.to_prometheus(ref, include_spans=False)
    assert port.snapshot() == ref.snapshot()
    assert obs.parse_prometheus(text) == jax_obs.parse_prometheus(text)
    h = port.get("seine_serve_latency_ms")
    for q in (50.0, 95.0, 100.0):
        assert h.percentile(q) == ref.get("seine_serve_latency_ms") \
            .percentile(q)


def test_json_dump_and_write_metrics(tmp_path):
    obs.reset_spans()          # the text format includes the span
    jax_obs.reset_spans()      # aggregates, which other tests fill
    port, ref = _record(obs), _record(jax_obs)
    a = obs.dump(str(tmp_path / "a.json"), port)
    b = jax_obs.dump(None, ref)
    assert a["metrics"] == b["metrics"]
    back = json.loads((tmp_path / "a.json").read_text())
    assert back["metrics"] == json.loads(json.dumps(b["metrics"]))
    obs.write_metrics(str(tmp_path / "m.prom"), port)
    assert (tmp_path / "m.prom").read_text() == jax_obs.to_prometheus(ref)


def test_span_exposition_matches_the_reference():
    """Span aggregates render under the reference's three families, with
    the same structure (the durations differ)."""
    for mod in (obs, jax_obs):
        mod.reset_spans()
        with mod.span("frontend.batch"):
            with mod.span("serve.request"):
                pass
        with mod.span("frontend.batch"):
            pass
    try:
        port = obs.parse_prometheus(obs.to_prometheus(obs.Registry()))
        ref = jax_obs.parse_prometheus(
            jax_obs.to_prometheus(jax_obs.Registry()))
        assert port.keys() == ref.keys() == {
            "seine_span_seconds_total", "seine_span_count_total",
            "seine_span_last_seconds"}
        assert port["seine_span_count_total"] == \
            ref["seine_span_count_total"]
        assert {k: v["count"] for k, v in obs.trace.snapshot().items()} \
            == {"frontend.batch": 2, "serve.request": 1}
    finally:
        obs.reset_spans()
        jax_obs.reset_spans()


def test_disabled_errors_and_log_lines(monkeypatch):
    reg = obs.Registry()
    c = reg.counter("x_total")
    with obs.disabled():
        c.inc(5)
        assert not obs.enabled()
    assert obs.enabled() and c.get() == 0.0
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("x_total")
    with pytest.raises(ValueError, match="unknown log level"):
        obs.set_level("loud")
    lines = []
    for mod in (obs, jax_obs):
        buf = io.StringIO()
        monkeypatch.setattr("sys.stderr", buf)
        mod.get_logger("seine.test").warning("slow batch", ms=3.5)
        lines.append(buf.getvalue())
    assert lines[0] == lines[1] == "[seine.test] WARNING: slow batch ms=3.5\n"


def _inventory(mod):
    doc = mod.__doc__
    table = doc[doc.index("Metric inventory"):]
    return {line.split()[0] for line in table.splitlines()
            if line.startswith("seine_")}


def test_serving_records_reference_families_only():
    """The engine, the serve loops and the front end record metrics whose
    names are in the reference's inventory, which the port's copy
    keeps."""
    assert _inventory(obs) == _inventory(jax_obs)
    obs.reset()
    idx = partition_index(build_zipfian_index(device="cpu"), 2)
    spec = get_retriever("knrm")
    eng = SeineEngine(idx, "knrm", spec.init(
        torch.Generator().manual_seed(0), idx.n_b, idx.functions,
        device="cpu"))
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 40, 4).astype(np.int32),
             rng.randint(0, idx.n_docs, 8).astype(np.int32))
            for _ in range(4)]
    serve_batches(eng, reqs + [(reqs[0][0], np.zeros(0, np.int32))])
    serve_retrieval(eng, [q for q, _ in reqs[:2]], 5)
    with ServingFrontend(eng, max_batch=2, batch_timeout_ms=1,
                         cache_tiles=4, slo_ms=60_000) as fe:
        for f in [fe.submit(q, d) for q, d in reqs]:
            f.result(timeout=120)
    recorded = {m.name for m in obs.REGISTRY.metrics()
                if m.samples() or getattr(m, "cells", None)}
    assert recorded <= _inventory(jax_obs)
    for name in ("seine_engine_scores_total", "seine_serve_requests_total",
                 "seine_serve_degenerate_requests_total",
                 "seine_retrieve_requests_total", "seine_lookup_found_ratio",
                 "seine_lookup_pairs_total", "seine_frontend_batches_total",
                 "seine_coalesce_distinct_pairs_total",
                 "seine_tile_cache_misses_total", "seine_serve_queue_wait_ms",
                 "seine_serve_latency_ms", "seine_index_nnz"):
        assert name in recorded, name
    assert obs.REGISTRY.get("seine_serve_requests_total").get() == 5
    spans = obs.trace.snapshot()
    assert spans["serve.request"]["count"] == 4
    assert spans["serve.retrieve"]["count"] == 2
    assert spans["frontend.batch"]["count"] >= 2


# -- the build, the partitioner, the codec and the checkpoint ---------------

@pytest.fixture(scope="module")
def port_builder(seine_world):
    """The port's builder on the CPU over seine_world's provider table
    and interaction parameters (the corpus arrays are seine_world's)."""
    from repro_torch.configs import seine_smoke
    from repro_torch.convert import (interaction_params_from_jax,
                                     provider_from_numpy)
    from repro_torch.core.builder import IndexBuilder
    from repro_torch.core.vocab import build_vocabulary
    from repro_torch.data.synth_corpus import generate
    w = seine_world
    cfg = seine_smoke()
    ds = generate(cfg, seed=0)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens,
                             keep_frac=cfg.vocab_keep_frac)
    return IndexBuilder(
        cfg, vocab,
        provider_from_numpy(np.asarray(w["provider"].table()), device="cpu"),
        ip=interaction_params_from_jax(w["builder"].ip, device="cpu"),
        device="cpu")


def _samples(mod, name):
    return dict(mod.REGISTRY.get(name).samples())


BUILD_FAMILIES = ("seine_build_docs_total", "seine_build_batches_total",
                  "seine_build_runs_total", "seine_build_total_nnz",
                  "seine_build_last_run_bytes", "seine_build_resident_bytes",
                  "seine_build_peak_host_bytes", "seine_merge_fan_in",
                  "seine_build_runs_spilled_total",
                  "seine_build_spill_bytes_total")
BUILD_SPANS = ("build.stream_runs", "build.stage1.uniq",
               "build.stage2.interact", "build.stage2b.compact",
               "build.stage3.spill", "build.stage4.merge")


@pytest.mark.parametrize("spill", [False, True])
def test_build_counters_and_stage_spans(seine_world, port_builder, spill,
                                        tmp_path):
    """The build's counters and gauges equal the reference's on the same
    corpus (they count docs, batches, runs and their bytes, all exact),
    and both record the same stage spans."""
    w = seine_world
    kw = dict(batch_size=16)
    for mod, builder in ((obs, port_builder), (jax_obs, w["builder"])):
        mod.reset()
        builder.build(w["toks"], w["segs"],
                      spill_dir=str(tmp_path / mod.__name__) if spill
                      else None, **kw)
    for name in BUILD_FAMILIES:
        if not spill and "spill" in name:
            continue
        assert _samples(obs, name) == _samples(jax_obs, name), name
    assert obs.gauge("seine_build_total_nnz").get() == w["index"].nnz
    assert obs.gauge("seine_build_docs_per_s").get() > 0
    assert set(obs.span_stats()) == set(jax_obs.span_stats()) \
        == set(BUILD_SPANS)


def test_partition_and_codec_record_the_reference_gauges(seine_world):
    """seine_shard_*, seine_plan_range_nnz and seine_codec_* equal the
    reference's for the same index; re-partitioning drops stale labels."""
    from repro.dist.sharding import partition_index as jax_partition
    from repro_torch.convert import index_to_device
    w = seine_world
    port = index_to_device(w["index"], device="cpu")
    names = ("seine_shard_nnz", "seine_shard_count",
             "seine_shard_skew_max_ratio", "seine_shard_skew_mean_ratio",
             "seine_shard_hot_splits", "seine_plan_range_nnz",
             "seine_codec_tile_bits_total", "seine_codec_bytes_saved",
             "seine_codec_shrink")
    for codec in ("packed", "packed-q8"):
        obs.reset()
        jax_obs.reset()
        partition_index(port, 2, codec=codec)
        jax_partition(w["index"], 2, codec=codec)
        for name in names:
            assert _samples(obs, name) == _samples(jax_obs, name), name
    assert set(_samples(obs, "seine_shard_nnz")) == {(("shard", "0"),),
                                                     (("shard", "1"),)}
    assert sum(_samples(obs, "seine_shard_nnz").values()) == port.nnz
    partition_index(port, 1)
    assert len(_samples(obs, "seine_shard_nnz")) == 1
    assert len(_samples(obs, "seine_plan_range_nnz")) == 1


def test_async_index_save_failure_recovers_previous(
        seine_world, tmp_path, monkeypatch):
    """An async save whose publish fails after the live index was moved
    aside: the failure is counted and raised by wait_async, and the
    previous index loads from the move-aside."""
    import dataclasses
    import os
    from repro_torch.ckpt import load_index, save_index, wait_async
    from repro_torch.convert import index_to_device
    obs.reset()
    index = index_to_device(seine_world["index"], device="cpu")
    d = str(tmp_path / "index")
    save_index(d, index)
    real_replace = os.replace

    def failing_replace(src, dst):
        if os.path.abspath(dst) == os.path.abspath(d):
            raise OSError("injected publish failure")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", failing_replace)
    gen2 = dataclasses.replace(index, values=index.values * 2.0)
    save_index(d, gen2, async_write=True)
    with pytest.raises(OSError, match="injected publish failure"):
        wait_async()
    monkeypatch.setattr(os, "replace", real_replace)
    assert obs.counter("seine_ckpt_write_errors_total").get() == 1.0
    assert obs.counter("seine_index_saves_total").get() == 1.0
    assert torch.equal(load_index(d, device="cpu").values, index.values)
    assert "ckpt.save_index" in obs.span_stats()
    # a later save publishes over the recovered state
    save_index(d, gen2, async_write=True)
    wait_async()
    assert torch.equal(load_index(d, device="cpu").values, gen2.values)


def test_sync_save_raises_and_counts(seine_world, tmp_path, monkeypatch):
    from repro_torch.ckpt import save_index
    from repro_torch.convert import index_to_device
    obs.reset()
    index = index_to_device(seine_world["index"], device="cpu")

    def boom(*a, **kw):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        save_index(str(tmp_path / "x"), index)
    assert obs.counter("seine_ckpt_write_errors_total").get() == 1.0
    assert obs.counter("seine_log_errors_total").get(
        logger="repro.ckpt") == 1.0


def test_concurrent_saves_of_one_dir_do_not_collide(seine_world, tmp_path):
    """Writes of one process to one directory each have their own
    temporary name (the reference's ``<dir>.tmp<pid>`` is shared, so two
    async writes publish into each other) and publish one at a time, and
    the last one wins: four async saves, 20 rounds."""
    from repro_torch.ckpt import load_index, save_index, wait_async
    from repro_torch.convert import index_to_device
    index = index_to_device(seine_world["index"], device="cpu")
    d = str(tmp_path / "index")
    for _ in range(20):
        for _ in range(4):
            save_index(d, index, async_write=True)
        wait_async()
        assert torch.equal(load_index(d, device="cpu").doc_ids,
                           index.doc_ids)
        assert os.listdir(tmp_path) == ["index"]
