"""Fault tolerance for long offline runs (index builds and ranker training):
a copy of ``repro.dist.fault``, which the port cannot import (its package
loads JAX).

SEINE's offline phase is the expensive one — a Gov2-scale index build or a
multi-day ranker train must survive slow hosts, lost heartbeats and
preemptions.  Three small, dependency-free pieces:

* :class:`Heartbeat` — liveness tracking per rank with an injectable clock;
* :class:`StragglerMonitor` — flags steps slower than ``tau`` x the running
  median (the signal that triggers re-balancing / backup tasks);
* :class:`PreemptionGuard` — cooperative SIGTERM handling so the train loop
  checkpoints and exits cleanly (see train.loop.fit);
* :func:`plan_elastic_mesh` — re-plan the (pod, data, model) mesh when chip
  counts change mid-run (elastic restart after partial pod loss).
"""
from __future__ import annotations

import signal as _signal
import statistics
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .. import obs


class Heartbeat:
    """Track per-rank liveness against a deadline.

    ``beat(rank)`` stamps the rank with the current clock; ``dead_ranks()``
    lists ranks whose last beat is older than ``deadline_s``.  The clock is
    injectable for tests (and for steady clocks in production).
    """

    def __init__(self, deadline_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline_s = float(deadline_s)
        self._clock = clock
        self._last: Dict[int, float] = {}

    def beat(self, rank: int) -> None:
        self._last[rank] = self._clock()
        obs.gauge("seine_heartbeat_ranks",
                  "ranks that have ever beaten").set(len(self._last))

    def dead_ranks(self) -> List[int]:
        now = self._clock()
        dead = sorted(r for r, t in self._last.items()
                      if now - t > self.deadline_s)
        if obs.enabled():
            age = obs.gauge("seine_heartbeat_age_seconds",
                            "seconds since each rank's last beat")
            for r, t in self._last.items():
                age.set(now - t, rank=str(r))
            obs.gauge("seine_heartbeat_dead_ranks",
                      "ranks past the liveness deadline").set(len(dead))
        return dead

    def alive_ranks(self) -> List[int]:
        dead = set(self.dead_ranks())
        return sorted(r for r in self._last if r not in dead)


class StragglerMonitor:
    """Flag steps slower than ``tau`` x the running median step time.

    Flagged samples are normally excluded from the baseline window so one
    straggler does not drag the median up and mask the next one — but every
    ``admit_every``-th *consecutive* slow step is admitted anyway, so a
    legitimate regime change (resume on slower hardware, new batch shape)
    re-normalises the median instead of flagging forever.  ``flagged``
    keeps at most ``max_flagged`` recent steps (multi-day runs must not
    grow it unboundedly).
    """

    def __init__(self, tau: float = 2.0, window: int = 100,
                 min_history: int = 5, admit_every: int = 10,
                 max_flagged: int = 10_000):
        self.tau = float(tau)
        self.min_history = int(min_history)
        self.admit_every = int(admit_every)
        self.max_flagged = int(max_flagged)
        self._times: deque = deque(maxlen=int(window))
        self._consecutive = 0
        self.flagged: List[int] = []

    def record(self, step: int, dt: float) -> bool:
        slow = (len(self._times) >= self.min_history
                and dt > self.tau * statistics.median(self._times))
        if slow:
            self._consecutive += 1
            self.flagged.append(step)
            if len(self.flagged) > self.max_flagged:
                del self.flagged[0]
            if self._consecutive % self.admit_every == 0:
                self._times.append(dt)          # regime-change escape hatch
            obs.counter("seine_straggler_flagged_total",
                        "steps flagged slower than tau x median").inc()
        else:
            self._consecutive = 0
            self._times.append(dt)
        if self._times and obs.enabled():
            obs.gauge("seine_straggler_median_step_seconds",
                      "running median step time").set(
                statistics.median(self._times))
        return slow

    @property
    def median(self) -> Optional[float]:
        return statistics.median(self._times) if self._times else None


class PreemptionGuard:
    """Cooperative preemption: flips ``should_stop`` on SIGTERM (or any
    configured signal) so the train loop checkpoints and returns instead of
    dying mid-step.  Previously installed handlers are chained."""

    def __init__(self, signals: Sequence[int] = (_signal.SIGTERM,),
                 install: bool = True):
        self._stop = False
        self._prev: Dict[int, object] = {}
        if install:
            for s in signals:
                self._prev[s] = _signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._stop = True
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def request_stop(self) -> None:
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def restore(self) -> None:
        for s, h in self._prev.items():
            _signal.signal(s, h)
        self._prev.clear()


def plan_elastic_mesh(n_chips: int, model: int, *,
                      chips_per_pod: int = 256) -> Tuple[int, ...]:
    """Re-plan the device mesh for ``n_chips`` survivors at fixed TP degree.

    Keeps the tensor-parallel ('model') degree intact — resharding TP state
    is the expensive direction — and gives every remaining chip to data
    parallelism.  Only when the survivors form >= 2 *complete* pods does the
    plan keep a separate 'pod' axis (cross-pod collectives are slower, so a
    partial pod folds into a single flat mesh instead):

        plan_elastic_mesh(512, 16) == (2, 16, 16)   # 2 full pods
        plan_elastic_mesh(384, 16) == (24, 16)      # 1.5 pods -> flat
    """
    if model <= 0:
        raise ValueError(f"model degree must be positive, got {model}")
    if n_chips < model:
        raise ValueError(
            f"{n_chips} chips cannot host tensor-parallel degree {model}")
    if n_chips % model:
        raise ValueError(
            f"{n_chips} chips not divisible by model degree {model}")
    if (n_chips % chips_per_pod == 0 and n_chips // chips_per_pod >= 2
            and chips_per_pod % model == 0):
        return (n_chips // chips_per_pod, chips_per_pod // model, model)
    return (n_chips // model, model)
