"""Lightweight tracing spans over the index lifecycle.

``with span("build.stage2.interact"): ...`` times a region with
``time.perf_counter()``, nests (a thread-local stack tracks the active
span path), and aggregates into per-name stats (count / total / min /
max / last).  Aggregates export through :mod:`repro_torch.obs.export` as
``seine_span_seconds_total{span=...}`` / ``seine_span_count_total`` /
``seine_span_last_seconds`` so build-stage timings ride the same
Prometheus/JSON snapshot as the counters and gauges.

Two optional sinks, both off by default:

* Chrome trace events (``chrome://tracing`` / Perfetto):
  :func:`enable_chrome_trace` starts collecting complete ("X") events,
  :func:`dump_chrome_trace` writes the JSON array.
* ``torch.profiler`` annotations: with ``REPRO_OBS_TORCH_TRACE=1`` each
  span also opens a ``torch.profiler.record_function`` so spans line up
  with device activity in a captured profile.  The flag costs nothing
  when unset.

A span measures *host wall-clock between enter and exit*: CUDA launches
are asynchronous, so wrap the synchronise (or the copy to the host) if
you want device time included (the serving loops' spans do).
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

from . import metrics as _metrics

_TORCH_TRACE = os.environ.get("REPRO_OBS_TORCH_TRACE", "") not in ("", "0")


class SpanStat:
    __slots__ = ("count", "total_s", "min_s", "max_s", "last_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0
        self.last_s = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)
        self.last_s = dt

    def snapshot(self) -> dict:
        return {"count": self.count, "total_s": self.total_s,
                "min_s": self.min_s if self.count else 0.0,
                "max_s": self.max_s, "last_s": self.last_s}


_STATS: Dict[str, SpanStat] = {}
_TLS = threading.local()
_CHROME: Optional[List[dict]] = None
_EPOCH = time.perf_counter()


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[None]:
    """Time a region and aggregate under ``name``.

    ``attrs`` ride into the Chrome-trace event args (and nowhere else —
    per-name aggregates stay unlabelled so the hot path never builds a
    label dict).
    """
    if not _metrics.enabled():
        yield
        return
    stack = _stack()
    stack.append(name)
    ann = None
    if _TORCH_TRACE:
        import torch
        ann = torch.profiler.record_function(name)
        ann.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if ann is not None:
            ann.__exit__(None, None, None)
        stack.pop()
        stat = _STATS.get(name)
        if stat is None:
            stat = _STATS[name] = SpanStat()
        stat.add(dt)
        if _CHROME is not None:
            _CHROME.append({
                "name": name, "ph": "X", "pid": os.getpid(),
                "tid": threading.get_ident(),
                "ts": (t0 - _EPOCH) * 1e6, "dur": dt * 1e6,
                "args": {**attrs, "depth": len(stack)},
            })


def current_span() -> Optional[str]:
    """Innermost active span name on this thread (None outside any)."""
    stack = _stack()
    return stack[-1] if stack else None


def span_stats() -> Dict[str, SpanStat]:
    return dict(_STATS)


def snapshot() -> dict:
    return {name: _STATS[name].snapshot() for name in sorted(_STATS)}


def reset_spans() -> None:
    _STATS.clear()


def enable_chrome_trace() -> None:
    """Start collecting Chrome-trace events (idempotent)."""
    global _CHROME
    if _CHROME is None:
        _CHROME = []


def disable_chrome_trace() -> None:
    global _CHROME
    _CHROME = None


def dump_chrome_trace(path: str) -> int:
    """Write collected events as a Chrome-trace JSON array; returns the
    event count (0 when collection was never enabled)."""
    events = _CHROME or []
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f)
    return len(events)
