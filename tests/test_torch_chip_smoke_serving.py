"""``chip_smoke.py`` phases 1-4 (the index, the kernels against their
plain versions, serving, the kernels' timing rows) rehearsed on the CPU
at a tiny size, phase 7's open-loop helpers, and the script's refusal to
run without a card.

The script's phases run end to end with the ops routed to the kernel
wrappers, whose CPU path is the plain version: every check the script
makes on the card then holds the plain version against itself, and must
find it bitwise equal.  The wrappers count launches only on the card, so
the names the ops import are wrapped in counters here
(``torch_chip_smoke_helpers``).  The timing helpers, which need the
card, are replaced by host-clock stand-ins.
"""
import gc
import os
import subprocess
import sys
import weakref
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro_torch.data.synth_corpus import build_zipfian_index
from repro_torch.dist.sharding import partition_index
from repro_torch.kernels.csr_lookup import ops as lookup_ops
from repro_torch.kernels.knrm_pool import ops as knrm_ops
from repro_torch.retrievers import get_retriever
from repro_torch.serving import SeineEngine
from torch_chip_smoke_helpers import (_load_script, _counting, _host_ms, _busy,
                                      KEYS, REPO)
import torch_threads  # noqa: F401  (PyTorch threads per test process)


@pytest.mark.parametrize("seed", [0, 1])
def test_phases_run_on_the_cpu(seed, monkeypatch):
    cs = _load_script()
    for name, value in dict(N_DOCS=1500, VOCAB=3000, TAIL_DRAWS=30,
                            N_CAND=120, N_REQUESTS=3, N_RETRIEVE=2,
                            TOP_K=50).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "events_ms", _host_ms)
    monkeypatch.setattr(cs, "device_ms",
                        lambda fns, iters, kernel, cold=False: None)
    monkeypatch.setattr(cs, "device_profile", lambda fns, iters: None)
    monkeypatch.setattr(cs, "device_busy", _busy)
    # the H100's: 16 per clock per SM x 132 SMs x 1,980 MHz
    monkeypatch.setattr(cs, "sfu_per_s", lambda: 16 * 132 * 1.98e9)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(lookup_ops, "_use_kernel",
                        lambda impl, like: impl in (None, "kernel"))
    for mod, name in ((lookup_ops, "csr_lookup_kernel"),
                      (lookup_ops, "lane_bounds_kernel"),
                      (lookup_ops, "retrieve_windows_kernel"),
                      (lookup_ops, "csr_lookup_packed_kernel"),
                      (lookup_ops, "lane_bounds_packed_kernel"),
                      (lookup_ops, "retrieve_windows_packed_kernel"),
                      (knrm_ops, "knrm_pool_kernel")):
        monkeypatch.setattr(mod, name, _counting(getattr(cs, name)))

    dev = torch.device("cpu")
    index, rng = cs.build_index(seed, dev)
    packed, _ = cs.build_packed(index)
    assert packed["none"].n_shards == cs.K_SHARDS
    assert packed["packed-q8"].values_q.dtype == torch.int8
    p2 = cs.phase2(index, rng, dev)
    cs.phase2_packed(index, packed, p2)
    requests, queries, launches = cs.phase3(index, packed, rng, dev, seed)
    kernels = cs.phase4(index, packed, requests, queries, launches, p2, dev)

    assert [k["name"] for k in kernels] == [
        "csr_lookup", "lane_bounds", "retrieve_windows", "knrm_pool",
        "csr_lookup_packed", "lane_bounds_packed", "retrieve_windows_packed"]
    for k in kernels:
        assert set(k) >= KEYS
        assert k["launches"] > 0
        assert all(n > 0 for n in k["launches_by_path"].values())
        for m in (k, k.get("q8", k)):
            assert m["max_abs_err"] == 0.0     # the plain version vs itself
            assert m["bound_ms"] > 0 and m["bound_by"] == (
                "operations" if k["name"] == "knrm_pool" else "bytes")
    # knrm_pool's bound is the largest of its three limits: its
    # exponentials on the special-function units here
    limits = kernels[3]["bound_limits"]
    assert kernels[3]["bound_ms"] == max(limits.values()) == limits["sfu"]
    # the lookup at the front end's coalesced shape: one (1, P) grid of the
    # distinct pairs of a batch
    # and the packed lookup's, under both codecs, warm and cold
    for co in (kernels[0]["coalesced"], kernels[4]["coalesced"],
               kernels[4]["q8"]["coalesced"]):
        assert co["distinct"] <= co["pairs"] and co["pairs"] % 256 == 0
        assert co["bound_ms"] > 0 and co["ms"] > 0
    assert kernels[4]["ms_cold"] > 0 and kernels[4]["q8"]["ms_cold"] > 0
    for i in (4, 5, 6):
        assert set(kernels[i]["launches_by_path"]) == {"packed", "packed-q8"}
    # one table per retrieval query and path, one launch per doc block
    n_blocks = -(-cs.N_DOCS // 1024)
    for table, scan in ((kernels[1], kernels[2]), (kernels[5], kernels[6])):
        for path, n in table["launches_by_path"].items():
            assert n == cs.N_RETRIEVE
            assert scan["launches_by_path"][path] == cs.N_RETRIEVE * n_blocks
        assert scan["library_ms"] > 0


@pytest.mark.parametrize("mode", ["naive", "coalesce", "cache"])
def test_open_loop_leaves_no_cycle(mode, monkeypatch):
    """Phase 7's ``open_loop`` records the run's futures without storing
    a wrapper on the front end, so the closed front end and its engine
    are freed without a collection (phase 6 then finds phase 5's index
    off the card)."""
    cs = _load_script()
    monkeypatch.setattr(cs, "FE_SLO_MS", 60_000.0)
    seen, attrs = [], []

    class Recorded(cs.ServingFrontend):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(weakref.ref(self))

        def close(self, timeout=None):
            attrs.append(set(vars(self)))
            super().close(timeout)

    monkeypatch.setattr(cs, "ServingFrontend", Recorded)
    index = partition_index(build_zipfian_index(n_docs=200, vocab=40, n_b=4,
                                                device="cpu"), 2)
    spec = get_retriever("knrm")
    eng = SeineEngine(index, "knrm", spec.init(
        torch.Generator().manual_seed(0), index.n_b, index.functions,
        device="cpu"))
    alive = weakref.ref(eng)
    rng = np.random.RandomState(2)
    reqs = [(rng.randint(-1, 40, 4).astype(np.int32),
             rng.randint(0, index.n_docs, 8).astype(np.int32))
            for _ in range(12)]
    kw = {"naive": dict(coalesce=False), "coalesce": {},
          "cache": dict(cache_tiles=8)}[mode]
    gc.disable()
    try:
        res, futures, _, _, _ = cs.open_loop(eng, reqs, 2000.0, 0, **kw)
        assert len(futures) == res.n_submitted == len(reqs)
        want = [eng.score(q, d).numpy() for q, d in reqs]
        assert cs.check_served(futures, want, "test") == res.n_served
        assert len(attrs) == 1 and "submit" not in attrs[0]
        assert seen[0]() is None           # freed on return, no cycle
        del eng, futures, res
        assert alive() is None
    finally:
        gc.enable()


def test_check_served_reads_rejections_without_raising():
    """A rejected future is skipped without raising its exception, so no
    traceback ties the exception to the frames that read it."""
    cs = _load_script()
    done, rejected = Future(), Future()
    done.set_result(np.arange(3.0))
    rejected.set_exception(cs.DeadlineExceeded("late"))
    assert cs.check_served([done, rejected], [np.arange(3.0)] * 2, "t") == 1
    assert rejected.exception().__traceback__ is None


def test_refuses_to_run_without_cuda():
    """No card: a non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
