"""Exporters: Prometheus text format + JSON snapshot, and a parser for
round-tripping the text format in tests.

``write_metrics(path)`` dispatches on extension — ``.json`` gets the
structured snapshot (metrics + span aggregates), anything else the
Prometheus 0.0.4 text exposition (``# HELP`` / ``# TYPE`` + samples;
histograms render cumulative ``_bucket{le=...}`` series plus ``_sum`` /
``_count``).  ``launch/serve.py --metrics-out`` and the bench lane write
through here.
"""
from __future__ import annotations

import json
import math
import re
import time
from typing import Dict, Optional, Tuple

from . import trace as _trace
from .metrics import REGISTRY, Histogram, LabelKey, Registry

SPAN_TOTAL = "seine_span_seconds_total"
SPAN_COUNT = "seine_span_count_total"
SPAN_LAST = "seine_span_last_seconds"


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(key: LabelKey, extra: Tuple[Tuple[str, str], ...] = ()
                ) -> str:
    items = tuple(key) + tuple(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


def to_prometheus(registry: Optional[Registry] = None,
                  include_spans: bool = True) -> str:
    """Serialise the registry (and span aggregates) as Prometheus text."""
    registry = registry or REGISTRY
    lines = []
    for m in registry.metrics():
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for key, cell in sorted(m.cells.items()):
                acc = 0
                for i, b in enumerate(m.buckets + (float("inf"),)):
                    acc += cell.counts[i]
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(key, (('le', _fmt_value(b)),))} "
                        f"{acc}")
                lines.append(f"{m.name}_sum{_fmt_labels(key)} "
                             f"{_fmt_value(cell.sum)}")
                lines.append(f"{m.name}_count{_fmt_labels(key)} "
                             f"{cell.count}")
        else:
            for key, v in m.samples():
                lines.append(f"{m.name}{_fmt_labels(key)} {_fmt_value(v)}")
    if include_spans:
        stats = _trace.span_stats()
        if stats:
            lines.append(f"# HELP {SPAN_TOTAL} cumulative seconds per span")
            lines.append(f"# TYPE {SPAN_TOTAL} counter")
            for name in sorted(stats):
                lines.append(f"{SPAN_TOTAL}{_fmt_labels((('span', name),))}"
                             f" {_fmt_value(stats[name].total_s)}")
            lines.append(f"# HELP {SPAN_COUNT} entries per span")
            lines.append(f"# TYPE {SPAN_COUNT} counter")
            for name in sorted(stats):
                lines.append(f"{SPAN_COUNT}{_fmt_labels((('span', name),))}"
                             f" {stats[name].count}")
            lines.append(f"# HELP {SPAN_LAST} most recent duration per span")
            lines.append(f"# TYPE {SPAN_LAST} gauge")
            for name in sorted(stats):
                lines.append(f"{SPAN_LAST}{_fmt_labels((('span', name),))}"
                             f" {_fmt_value(stats[name].last_s)}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{(.*)\})?"                        # optional label body
    r"\s+([^\s]+)\s*$")                     # value
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, Dict[LabelKey, float]]:
    """Parse Prometheus text back to ``{name: {label_key: value}}``.

    Covers the subset :func:`to_prometheus` emits (which is the subset
    real scrapers emit too) — the round-trip test in
    tests/test_obs.py holds ``parse(to_prometheus(r))`` equal to the
    registry's own samples.
    """
    out: Dict[str, Dict[LabelKey, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable sample line: {line!r}")
        name, label_body, value = m.groups()
        labels = ()
        if label_body:
            labels = tuple(sorted(
                (k, v.replace('\\"', '"').replace("\\\\", "\\"))
                for k, v in _LABEL_RE.findall(label_body)))
        v = {"+Inf": math.inf, "-Inf": -math.inf,
             "NaN": math.nan}.get(value)
        out.setdefault(name, {})[labels] = (float(value) if v is None
                                            else v)
    return out


def snapshot(registry: Optional[Registry] = None) -> dict:
    """The JSON-able structured snapshot: metric families + span stats."""
    registry = registry or REGISTRY
    return {"time": time.time(),
            "metrics": registry.snapshot(),
            "spans": _trace.snapshot()}


def dump(path: Optional[str] = None,
         registry: Optional[Registry] = None) -> dict:
    """Snapshot the registry; optionally also write it to ``path`` as
    JSON.  Returns the snapshot dict either way."""
    snap = snapshot(registry)
    if path is not None:
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
    return snap


def write_metrics(path: str, registry: Optional[Registry] = None) -> str:
    """Write the current metrics to ``path``: JSON when it ends in
    ``.json``, Prometheus text otherwise.  Returns the path."""
    if path.endswith(".json"):
        dump(path, registry)
    else:
        with open(path, "w") as f:
            f.write(to_prometheus(registry))
    return path
