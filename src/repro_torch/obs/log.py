"""Structured logger the scattered ``print()`` telemetry moved onto.

Zero-dependency, stderr-only (stdout stays free for CSV/JSON artifacts
the bench and launch scripts emit).  Level comes from ``REPRO_LOG``
(debug/info/warning/error, default info); ``REPRO_LOG_JSON=1`` switches
to one JSON object per line (machine-ingestable), otherwise the human
format is ``[name] message key=value ...``.

    from repro_torch.obs import get_logger
    log = get_logger("repro_torch.serving")
    log.info("streamed docs", done=128, total=4096, resident_mb=3.2)

``log.error`` also increments the ``seine_log_errors_total`` counter so
fault lines surface in the metrics snapshot even when nobody kept the
stderr stream.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict

from . import metrics as _metrics

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

_level = LEVELS.get(os.environ.get("REPRO_LOG", "info").strip().lower(), 20)
_json_lines = os.environ.get("REPRO_LOG_JSON", "") not in ("", "0")


def set_level(name: str) -> None:
    """Override the REPRO_LOG threshold programmatically (tests, scripts)."""
    global _level
    if name.strip().lower() not in LEVELS:
        raise ValueError(f"unknown log level {name!r}; "
                         f"one of {sorted(LEVELS)}")
    _level = LEVELS[name.strip().lower()]


def level_name() -> str:
    return {v: k for k, v in LEVELS.items()}[_level]


class Logger:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _emit(self, level: str, msg: str, fields: dict) -> None:
        if LEVELS[level] < _level:
            return
        if _json_lines:
            rec = {"ts": time.time(), "level": level, "logger": self.name,
                   "msg": msg}
            rec.update(fields)
            line = json.dumps(rec, default=str)
        else:
            tail = "".join(f" {k}={v}" for k, v in fields.items())
            tag = "" if level == "info" else f" {level.upper()}:"
            line = f"[{self.name}]{tag} {msg}{tail}"
        sys.stderr.write(line + "\n")

    def debug(self, msg: str, **fields) -> None:
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields) -> None:
        self._emit("info", msg, fields)

    def warning(self, msg: str, **fields) -> None:
        self._emit("warning", msg, fields)

    def error(self, msg: str, **fields) -> None:
        _metrics.counter("seine_log_errors_total",
                         "error-level log lines").inc(logger=self.name)
        self._emit("error", msg, fields)


_LOGGERS: Dict[str, Logger] = {}


def get_logger(name: str) -> Logger:
    lg = _LOGGERS.get(name)
    if lg is None:
        lg = _LOGGERS[name] = Logger(name)
    return lg
