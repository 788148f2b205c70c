"""The port's ``dist.fault`` against ``repro.dist.fault``: the same beats,
step times, signals and chip counts give the same answers and the same
``seine_heartbeat_*`` / ``seine_straggler_*`` metrics (the reference's
tests/test_obs.py heartbeat case, tests/test_train_ckpt_dist.py's fault
tests and tests/test_dist_sharding.py's elastic-mesh sweep)."""
import os
import signal

import numpy as np
import pytest

from repro import obs as jax_obs
from repro.dist import fault as jax_fault
from repro_torch import obs
from repro_torch.dist import fault
import torch_threads  # noqa: F401  (PyTorch threads per test process)


def _both():
    return ((fault, obs), (jax_fault, jax_obs))


def _samples(mod, name):
    return dict(mod.REGISTRY.get(name).samples())


def test_heartbeat_and_straggler_gauges_match_the_reference():
    got = []
    for mod, o in _both():
        o.reset()
        t = [0.0]
        hb = mod.Heartbeat(deadline_s=10.0, clock=lambda: t[0])
        hb.beat(0)
        hb.beat(1)
        t[0] = 20.0
        hb.beat(1)
        dead, alive = hb.dead_ranks(), hb.alive_ranks()
        mon = mod.StragglerMonitor(tau=2.0, min_history=2)
        for _ in range(4):
            mon.record(0, 1.0)
        flagged = mon.record(1, 10.0)
        got.append((dead, alive, flagged, mon.flagged, mon.median,
                    {n: _samples(o, n) for n in (
                        "seine_heartbeat_ranks",
                        "seine_heartbeat_age_seconds",
                        "seine_heartbeat_dead_ranks",
                        "seine_straggler_flagged_total",
                        "seine_straggler_median_step_seconds")}))
    assert got[0] == got[1]
    assert got[0][0] == [0] and got[0][2] is True
    assert obs.gauge("seine_heartbeat_age_seconds").get(rank="0") == 20.0


def test_straggler_monitor_and_regime_change():
    rng = np.random.RandomState(0)
    times = np.concatenate([rng.uniform(0.09, 0.11, 20), [0.5, 0.11],
                            np.full(25, 0.4)])
    flags = []
    for mod, _ in _both():
        m = mod.StragglerMonitor(tau=2.0, admit_every=10, max_flagged=5)
        flags.append(([m.record(i, float(dt)) for i, dt in
                       enumerate(times)], list(m.flagged), m.median))
    assert flags[0] == flags[1]
    assert flags[0][0][20] and not flags[0][0][21]
    assert len(flags[0][1]) == 5                   # bounded history


def test_heartbeat_with_fake_clock():
    t = [0.0]
    hb = fault.Heartbeat(deadline_s=10.0, clock=lambda: t[0])
    hb.beat(0)
    hb.beat(1)
    t[0] = 5.0
    hb.beat(0)
    t[0] = 12.0
    assert hb.dead_ranks() == [1] and hb.alive_ranks() == [0]


def test_preemption_guard_chains_and_restores():
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        g = fault.PreemptionGuard(signals=(signal.SIGUSR1,))
        assert not g.should_stop
        os.kill(os.getpid(), signal.SIGUSR1)
        assert g.should_stop and seen == [signal.SIGUSR1]
        g.restore()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert seen == [signal.SIGUSR1] * 2
        manual = fault.PreemptionGuard(install=False)
        manual.request_stop()
        assert manual.should_stop
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_elastic_mesh_plans_match_the_reference():
    assert fault.plan_elastic_mesh(512, 16) == (2, 16, 16)
    assert fault.plan_elastic_mesh(384, 16) == (24, 16)
    rng = np.random.RandomState(5)
    for model in (4, 8, 16, 32):
        for _ in range(8):
            n = int(rng.randint(1, 80)) * model
            assert fault.plan_elastic_mesh(n, model) == \
                jax_fault.plan_elastic_mesh(n, model)
            for bad in (n + int(rng.randint(1, model)), model // 2, 0):
                for mod in (fault, jax_fault):
                    with pytest.raises(ValueError):
                        mod.plan_elastic_mesh(bad, model)
    with pytest.raises(ValueError, match="positive"):
        fault.plan_elastic_mesh(16, 0)
