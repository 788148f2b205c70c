"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

Pure Python, zero dependencies, designed for the single-writer hot loop:
every record op is a dict upsert guarded by one module-level ``_ENABLED``
bool, so a disabled registry costs a single attribute load + branch per
call and an enabled one stays O(1) with no locks (CPython dict ops are
atomic enough for the one background ckpt-writer thread that also
increments counters; there is deliberately no cross-process story here —
each process exports its own snapshot).

Metric families are keyed by name; samples within a family are keyed by a
sorted ``(label, value)`` tuple, which is exactly the Prometheus data
model the exporters in :mod:`repro_torch.obs.export` serialise.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

_ENABLED = True

# serve-loop latencies land in single-digit ms on the smoke corpus and
# single-digit seconds at pod scale — one fixed log-ish ladder covers both
DEFAULT_MS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                      50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0)
DEFAULT_S_BUCKETS = tuple(b / 1e3 for b in DEFAULT_MS_BUCKETS) + (10.0, 60.0)

LabelKey = Tuple[Tuple[str, str], ...]


def enabled() -> bool:
    """True when record ops (inc/set/observe/span) are live."""
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Context manager: suspend all recording (the overhead-test control
    arm, and an opt-out for latency-critical sections)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = False
    try:
        yield
    finally:
        _ENABLED = prev


def _label_key(labels: Dict[str, object]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Metric:
    """One metric family: a name, a help string, and labelled samples."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.values: Dict[LabelKey, float] = {}

    def get(self, **labels) -> float:
        return self.values.get(_label_key(labels), 0.0)

    def samples(self) -> List[Tuple[LabelKey, float]]:
        return sorted(self.values.items())

    def clear(self) -> None:
        self.values.clear()

    def snapshot(self) -> dict:
        return {"kind": self.kind, "help": self.help,
                "samples": [{"labels": dict(k), "value": v}
                            for k, v in self.samples()]}


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not _ENABLED:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0.0) + amount


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not _ENABLED:
            return
        self.values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not _ENABLED:
            return
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class _HistCell:
    """Per-labelset histogram state: bucket counts + running sum/count."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(Metric):
    """Fixed-bucket histogram (cumulative-on-export, Prometheus style).

    ``observe`` is a linear scan over ~16 upper bounds — at serve-loop
    rates that is tens of ns, far below the timer reads surrounding it.
    Buckets are fixed at construction; re-requesting the same name with
    different buckets keeps the original (first writer wins), matching
    registry get-or-create semantics.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_MS_BUCKETS):
        super().__init__(name, help)
        self.buckets: Tuple[float, ...] = tuple(sorted(float(b)
                                                       for b in buckets))
        self.cells: Dict[LabelKey, _HistCell] = {}

    def observe(self, value: float, **labels) -> None:
        if not _ENABLED:
            return
        k = _label_key(labels)
        cell = self.cells.get(k)
        if cell is None:
            cell = self.cells[k] = _HistCell(len(self.buckets))
        i = 0
        for b in self.buckets:
            if value <= b:
                break
            i += 1
        cell.counts[i] += 1
        cell.sum += value
        cell.count += 1

    def samples(self) -> List[Tuple[LabelKey, float]]:
        # the scalar view of a histogram is its running sum (export.py
        # renders the full bucket structure from .cells directly)
        return sorted((k, c.sum) for k, c in self.cells.items())

    def clear(self) -> None:
        self.cells.clear()

    def percentile(self, q: float, **labels) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the q-th sample); exact tails live with the recorder."""
        cell = self.cells.get(_label_key(labels))
        if cell is None or cell.count == 0:
            return 0.0
        target = max(1, int(round(q / 100.0 * cell.count)))
        acc = 0
        for i, c in enumerate(cell.counts):
            acc += c
            if acc >= target:
                return (self.buckets[i] if i < len(self.buckets)
                        else float("inf"))
        return float("inf")

    def snapshot(self) -> dict:
        out = {"kind": self.kind, "help": self.help,
               "buckets": list(self.buckets), "samples": []}
        for k, cell in sorted(self.cells.items()):
            out["samples"].append({"labels": dict(k),
                                   "counts": list(cell.counts),
                                   "sum": cell.sum, "count": cell.count})
        return out


class Registry:
    """Name -> metric family, with kind-checked get-or-create access."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        elif help and not m.help:
            m.help = help
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        kw = {"buckets": buckets} if buckets is not None else {}
        return self._get(Histogram, name, help, **kw)

    def get(self, name: str) -> Optional[Metric]:
        """The registered family, or None — read-only lookup that never
        creates (use counter()/gauge()/histogram() to record)."""
        return self._metrics.get(name)

    def metrics(self) -> List[Metric]:
        return [self._metrics[n] for n in sorted(self._metrics)]

    def snapshot(self) -> dict:
        return {m.name: m.snapshot() for m in self.metrics()}

    def reset(self) -> None:
        """Zero every sample but keep the registered families (tests)."""
        for m in self._metrics.values():
            m.clear()


REGISTRY = Registry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return REGISTRY.histogram(name, help, buckets)
