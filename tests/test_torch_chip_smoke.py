"""``chip_smoke.py`` rehearsed on the CPU at a tiny size.

The script's phases run end to end with the ops routed to the kernel
wrappers, whose CPU path is the plain version: every check the script
makes on the card then holds the plain version against itself, and must
find it bitwise equal.  The wrappers count launches only on the card, so
the names the ops import are wrapped in counters here.  The timing
helpers, which need the card, are replaced by host-clock stand-ins.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import time

import pytest
import torch

from repro_torch.configs import smoke
from repro_torch.core import interactions
from repro_torch.kernels.csr_lookup import ops as lookup_ops
from repro_torch.kernels.embed_bag import ops as eb_ops
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.knrm_pool import ops as knrm_ops
from repro_torch.kernels.seg_interact import ops as seg_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counting(fn):
    def wrapper(*a, **k):
        fn.launches += 1
        return fn(*a, **k)
    return wrapper


def _host_ms(fns, iters):
    """One pass over ``fns`` on the host clock (``iters`` is for the
    card's timing loops)."""
    t0 = time.perf_counter()
    for fn in fns:
        fn()
    return (time.perf_counter() - t0) * 1e3 / len(fns)


def _busy(run, n):
    """``device_busy``'s stand-in: the card's profile is not replayed."""
    return dict(ms=1.0, ops=1.0, host="", recorded=1, launched=1)


def _patch_build(cs, monkeypatch, tmp_path, **sizes):
    """Phase 5 at a hundred-odd docs, n_b 5, De 32, with the kernels'
    names wrapped in launch counters and card-only timing stubbed."""
    for name, value in dict(BUILD_DOCS=130, BUILD_N_B=5, BUILD_DE=32,
                            BUILD_MAX_LEN=160, BUILD_MAX_UNIQ=128,
                            N_CAND=60, N_REQUESTS=3, NOINDEX_REQUESTS=2,
                            INDEX_DIR=str(tmp_path / "idx"),
                            **sizes).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "events_ms", _host_ms)
    monkeypatch.setattr(cs, "device_ms",
                        lambda fns, iters, kernel, cold=False: None)
    monkeypatch.setattr(cs, "device_busy", _busy)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(lookup_ops, "_use_kernel",
                        lambda impl, like: impl in (None, "kernel"))
    for mod, name in ((lookup_ops, "csr_lookup_kernel"),
                      (lookup_ops, "retrieve_windows_kernel"),
                      (knrm_ops, "knrm_pool_kernel"),
                      (interactions, "seg_interact_kernel"),
                      (seg_ops, "seg_interact_kernel"),
                      (eb_ops, "embed_bag_kernel")):
        monkeypatch.setattr(mod, name, _counting(getattr(cs, name)))


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
    monkeypatch.setattr(cs, "device_busy", _busy)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(lookup_ops, "_use_kernel",
                        lambda impl, like: impl in (None, "kernel"))
    for mod, name in ((lookup_ops, "csr_lookup_kernel"),
                      (lookup_ops, "retrieve_windows_kernel"),
                      (lookup_ops, "csr_lookup_packed_kernel"),
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
        "csr_lookup", "retrieve_windows", "knrm_pool", "csr_lookup_packed",
        "retrieve_windows_packed"]
    for k in kernels:
        assert set(k) >= KEYS
        assert k["launches"] > 0
        assert all(n > 0 for n in k["launches_by_path"].values())
        for m in (k, k.get("q8", k)):
            assert m["max_abs_err"] == 0.0     # the plain version vs itself
            assert m["bound_ms"] > 0 and m["bound_by"] == "bytes"
    assert set(kernels[3]["launches_by_path"]) == {"packed", "packed-q8"}


@pytest.mark.parametrize("seed", [0, 1])
def test_build_phase_runs_on_the_cpu(seed, monkeypatch, tmp_path):
    """Phase 5 (the offline build) at a hundred-odd docs, n_b 5, De 32:
    the build, its checks, both engines over the built index and the
    save/load round trip; embed_bag twice per build batch."""
    cs = _load_script()
    _patch_build(cs, monkeypatch, tmp_path)
    rows, built = cs.phase5(seed, torch.device("cpu"))
    row, eb = rows
    assert set(row) >= KEYS and set(eb) >= KEYS
    assert row["name"] == "seg_interact" and row["route"] == "cuda"
    assert row["replaces"] == "src/repro/kernels/seg_interact/kernel.py:50"
    assert row["launches"] == -(-130 // 32)       # one per build batch
    assert row["launches_by_path"]["noindex"] > 0
    assert row["max_abs_err"] == 0.0           # the plain version vs itself
    assert row["bound_ms"] > 0 and row["library_ms"] is None
    assert eb["name"] == "embed_bag" and eb["route"] == "cuda"
    assert eb["replaces"] == "src/repro/kernels/embed_bag/kernel.py:40"
    assert eb["source"] == \
        "src/repro_torch/kernels/embed_bag/csrc/embed_bag.cu"
    assert eb["launches"] == 2 * -(-130 // 32)    # provider mix + lcp
    assert eb["launches_by_path"]["noindex"] > 0
    assert eb["max_abs_err"] == 0.0 and eb["bitwise"]
    assert eb["bound_ms"] > 0 and eb["bound_by"] == "bytes"
    assert eb["library_ms"] > 0 and eb["log_cond_prob"]["bound_ms"] > 0
    assert set(built) == {"pidx", "engine", "ds", "vocab"}
    assert not os.path.exists(tmp_path / "idx")


@pytest.mark.parametrize("seed", [0, 1])
def test_frontend_phase_runs_on_the_cpu(seed, monkeypatch, tmp_path):
    """Phase 7 (the serving front end) over phase 5's index: the three
    modes, every served score equal to engine.score, and the swap to a
    packed copy."""
    cs = _load_script()
    _patch_build(cs, monkeypatch, tmp_path, FE_CLOSED=4, FE_REQUESTS=12,
                 FE_CACHE_TILES=64, FE_SWAP_REQUESTS=3, FE_SLO_MS=60_000.0)
    monkeypatch.setattr(lookup_ops, "csr_lookup_packed_kernel",
                        _counting(cs.csr_lookup_packed_kernel))
    _, built = cs.phase5(seed, torch.device("cpu"))
    results = cs.phase7(built, seed, torch.device("cpu"))
    assert list(results) == [f"{m} @ {f} R" for f in ("1", "0.5")
                             for m in ("naive", "coalesce", "coalesce+cache")]
    for mode, r in results.items():
        assert r["served"] + r["rejected"] == 12 and r["served"] > 0
        assert 0.0 <= r["goodput"] <= 1.0 and r["batches"] >= 2
        assert (r["dedupe"] is None) == mode.startswith("naive")


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_phase_runs_on_the_cpu(seed, monkeypatch):
    """Phase 6 (the LM bridge) at smoke("minitron-4b") in bf16 over 48
    docs in batches of 16: weights, the kernel checks, the wiring check,
    the LM build with flash_attn counted per layer and batch, indexed ==
    No-Index, both engines and the timing row."""
    cs = _load_script()
    for name, value in dict(BUILD_DOCS=80, BUILD_N_B=5, BUILD_DE=32,
                            BUILD_MAX_LEN=160, BUILD_MAX_UNIQ=128,
                            LM_DOCS=48, LM_BATCH=16, LM_CAND=40,
                            LM_NOINDEX_CAND=16).items():
        monkeypatch.setattr(cs, name, value)
    lm = dataclasses.replace(smoke("minitron-4b"), dtype="bfloat16")
    monkeypatch.setattr(cs, "lm_config", lambda: lm)
    monkeypatch.setattr(cs, "events_ms", _host_ms)
    monkeypatch.setattr(cs, "device_ms",
                        lambda fns, iters, kernel, cold=False: None)
    monkeypatch.setattr(cs, "kernel_split", lambda run, n: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(lookup_ops, "_use_kernel",
                        lambda impl, like: impl in (None, "kernel"))
    for mod, name in ((lookup_ops, "csr_lookup_kernel"),
                      (lookup_ops, "retrieve_windows_kernel"),
                      (knrm_ops, "knrm_pool_kernel"),
                      (interactions, "seg_interact_kernel"),
                      (seg_ops, "seg_interact_kernel"),
                      (fa_ops, "flash_attn_kernel")):
        monkeypatch.setattr(mod, name, _counting(getattr(cs, name)))

    row = cs.phase6(seed, torch.device("cpu"), cs.build_corpus(seed))
    assert set(row) >= KEYS
    assert row["name"] == "flash_attn" and row["route"] == "cuda"
    assert row["replaces"] == "src/repro/kernels/flash_attn/kernel.py:63"
    assert row["source"] == \
        "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu"
    assert row["launches"] == lm.n_layers * -(-48 // 16)
    assert row["launches_by_path"]["noindex"] > 0
    assert row["max_abs_err"] == row["f32_max_abs_err"] == 0.0
    assert row["bound_ms"] > 0 and row["library_ms"] > 0
    assert row["peak_bytes"] is None

def test_refuses_to_run_without_cuda():
    """No card: a non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
