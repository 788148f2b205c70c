"""The port's copy of ``obs`` against ``repro.obs``: the same metric
operations give the same Prometheus exposition text and the same JSON
snapshot, and the serving path records only metric families of the
reference's inventory."""
import io
import json
import math

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
