"""``chip_smoke.py`` rehearsed on the CPU at a tiny size.

The script's phases run end to end with the ops routed to the kernel
wrappers, whose CPU path is the plain version: every check the script
makes on the card then holds the plain version against itself, and must
find it bitwise equal.  The wrappers count launches only on the card, so
the names the ops import are wrapped in counters here.  The timing
helpers, which need the card, are replaced by host-clock stand-ins.
"""
import dataclasses
import gc
import importlib.util
import os
import subprocess
import sys
import time
import weakref
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke
from repro_torch.data.synth_corpus import build_zipfian_index
from repro_torch.dist.sharding import partition_index
from repro_torch.core import interactions
from repro_torch.kernels.csr_lookup import ops as lookup_ops
from repro_torch.kernels.embed_bag import ops as eb_ops
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.knrm_pool import ops as knrm_ops
from repro_torch.kernels.seg_interact import ops as seg_ops
from repro_torch.retrievers import get_retriever
from repro_torch.serving import SeineEngine

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


def _counting_segments(fn, counter):
    """The segment entry counts on the CSR entry's counter."""
    def wrapper(*a, **k):
        counter.launches += 1
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
    monkeypatch.setattr(eb_ops, "embed_bag_segment_kernel", _counting_segments(
        cs.embed_bag_segment_kernel, cs.embed_bag_kernel))


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
    assert row["noindex_bound_ms"] > 0 and row["noindex_plain_ms"] > 0
    assert row["noindex_ms"] > 0 and row["noindex_share"] > 0
    assert eb["name"] == "embed_bag" and eb["route"] == "cuda"
    assert eb["replaces"] == "src/repro/kernels/embed_bag/kernel.py:40"
    assert eb["source"] == \
        "src/repro_torch/kernels/embed_bag/csrc/embed_bag.cu"
    assert eb["launches"] == 2 * -(-130 // 32)    # provider mix + lcp
    assert eb["launches_by_path"]["noindex"] > 0
    assert eb["max_abs_err"] == 0.0 and eb["bitwise"]
    assert eb["bound_ms"] > 0 and eb["bound_by"] == "bytes"
    assert eb["library_ms"] > 0 and eb["log_cond_prob"]["bound_ms"] > 0
    assert set(built) == {"pidx", "engine", "ds", "vocab", "builder", "toks",
                          "segs"}
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


def test_live_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """Phase 8 (the live index, the CLI and the repaired kernels) over
    phase 5's index at 130 docs, n_b 5, De 32: the ingest of 64 docs
    again while the front end serves, the tombstones, the compaction
    while it serves, the rebuild contract, the three CLI runs and the
    any-segment-count rows."""
    cs = _load_script()
    _patch_build(cs, monkeypatch, tmp_path, FE_REQUESTS=12,
                 FE_CACHE_TILES=64, FE_SLO_MS=60_000.0, LIVE_DOCS=64,
                 LIVE_DEAD=4, LIVE_WAVE=12, LIVE_QD_REQUESTS=3, LIVE_AFTER=3,
                 LIVE_SMALL=(64, 32), LIVE_SMALL_TOP_K=10, N_RETRIEVE=2,
                 TOP_K=20, REPAIR_SEG=(65, 130), REPAIR_NB=(20, 1025),
                 CLI_METRICS=str(tmp_path / "serve_metrics.txt"))
    for mod, name in ((lookup_ops, "lane_bounds_kernel"),
                      (lookup_ops, "csr_lookup_packed_kernel")):
        monkeypatch.setattr(mod, name, _counting(getattr(cs, name)))
    _, built = cs.phase5(0, torch.device("cpu"))
    built["qps"] = 400.0
    out = cs.phase8(built, 0, torch.device("cpu"))
    assert set(out["repairs"]) == {"seg_interact", "knrm_pool"}
    assert set(out["repairs"]["seg_interact"]) == {"5", "65", "130"}
    assert set(out["repairs"]["knrm_pool"]) == {"20", "1025"}
    for rows in out["repairs"].values():
        assert all(r["max_abs_err"] == 0.0 and r["ms"] > 0
                   for r in rows.values())
    for wave in (out["during_ingest"], out["during_compact"]):
        assert wave["served"] + wave["rejected"] == 12 and wave["served"]
    assert len(out["cli"]) == 3
    assert out["compaction_s"]["explode"] > 0
    assert out["compaction_s"]["merge_and_upload"] > 0


def test_train_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """Phase 9 (ranker training) over phase 5's index at 130 docs, n_b 5,
    De 32: KNRM with checkpoints and the resume, the first step against
    the plain path, DeepTileBars, the LETOR metrics of four rankers, the
    card-against-CPU run and the training CLI, at a few steps each."""
    cs = _load_script()
    _patch_build(cs, monkeypatch, tmp_path, TRAIN_STEPS=8, TRAIN_CKPT_EVERY=2,
                 TRAIN_RESUME_FROM=4, TRAIN_BAR=4, DTB_STEPS=4, DTB_BAR=2,
                 CPU_STEPS=3, CLI_TRAIN_STEPS=2, BUSY_STEPS=2,
                 TRAIN_DIR=str(tmp_path / "train"))
    _, built = cs.phase5(0, torch.device("cpu"))
    out = cs.phase9(built, 0, torch.device("cpu"))
    # one lookup and one knrm_pool per score: two scores per pair
    assert out["per_step"] == {"csr_lookup": 2 * cs.TRAIN_BATCH,
                               "knrm_pool": 2 * cs.TRAIN_BATCH}
    assert set(out["effectiveness"]) == {
        "BM25", "KNRM at init", "KNRM after 8 steps",
        "DeepTileBars after 4 steps"}
    for mm in out["effectiveness"].values():
        assert set(mm) == set(cs.LETOR_METRICS)
        assert all(0.0 <= v <= 1.0 for v in mm.values())
    assert out["cli"]["launches"]["knrm_pool"] >= 2
    assert out["p95_ms"] >= out["p50_ms"] > 0 and out["peak_gb"] is None
    assert not os.path.exists(tmp_path / "train")


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
    assert row["f32_bound_ms"] > 0 and row["f32_library_ms"] > 0
    assert row["f32_plain_ms"] > 0
    assert row["peak_bytes"] is None

def _patch_lm(cs, monkeypatch, **sizes):
    """The LM phases at a few dozen docs of 160 tokens in batches of 16,
    the kernels' names wrapped in launch counters, card-only timing
    stubbed."""
    for name, value in dict(BUILD_DOCS=80, BUILD_N_B=5, BUILD_DE=32,
                            BUILD_MAX_LEN=160, BUILD_MAX_UNIQ=128,
                            LM_DOCS=48, LM_BATCH=16, LM_CAND=40,
                            LM_NOINDEX_CAND=16, **sizes).items():
        monkeypatch.setattr(cs, name, value)
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
                      (fa_ops, "flash_attn_kernel"),
                      (eb_ops, "embed_bag_kernel")):
        monkeypatch.setattr(mod, name, _counting(getattr(cs, name)))
    monkeypatch.setattr(eb_ops, "embed_bag_segment_kernel", _counting_segments(
        cs.embed_bag_segment_kernel, cs.embed_bag_kernel))


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_phase_runs_on_the_cpu(seed, monkeypatch):
    """Phase 10 (the MoE LM bridge and decode) at smoke("granite-moe-
    3b-a800m") in bf16 with the published capacity factor 1.25 (pairs
    drop) over 48 docs in batches of 16: the weights and their count,
    the kernel check, the build with flash_attn counted per layer and
    batch and the dropped share per batch, indexed == No-Index, both
    engines, decode against the forward in float32, the slice merge and
    the timing row."""
    cs = _load_script()
    _patch_lm(cs, monkeypatch, MOE_DOCS=48, DECODE_PROMPT_LEN=40,
              DECODE_STEPS=4)
    base = smoke("granite-moe-3b-a800m")
    lm = dataclasses.replace(base, dtype="bfloat16", moe=dataclasses.replace(
        base.moe, capacity_factor=1.25))
    monkeypatch.setattr(cs, "moe_config", lambda: lm)
    row = cs.phase10(seed, torch.device("cpu"), cs.build_corpus(seed))
    assert set(row) >= KEYS
    assert row["name"] == "flash_attn_hd64" and row["route"] == "cuda"
    assert row["replaces"] == "src/repro/kernels/flash_attn/kernel.py:63"
    assert row["shape"] == [16, 160, lm.n_heads, lm.n_kv_heads, lm.head_dim]
    assert row["launches"] == lm.n_layers * -(-48 // 16)
    assert row["launches_by_path"]["noindex"] > 0
    assert row["max_abs_err"] == row["f32_max_abs_err"] == 0.0
    assert 0.0 < row["dropped_share"] < 1.0
    assert 0.0 <= row["dropped_share_own_tokens"] < 1.0
    dec = row["decode"]
    assert dec["p95_ms"] >= dec["p50_ms"] > 0 and dec["tokens_per_s"] > 0
    assert dec["cache_bytes"] == 2 * lm.n_layers * 8 * 44 * lm.n_kv_heads \
        * lm.head_dim * 2
    assert 0.0 <= dec["greedy_agreement"] <= 1.0
    assert dec["greedy_margin"] >= 0.0 and dec["logit_diff"] >= 0.0
    assert dec["merge_max_abs_err"] <= 1e-5
    assert row["peak_bytes"] is None


def test_snrm_phase_runs_on_the_cpu(monkeypatch):
    """Phase 11 (SNRM) over 80 docs: the first step against the CPU, a
    few steps, the chunked encoding and the P@k beside phase 9's rows."""
    cs = _load_script()
    _patch_lm(cs, monkeypatch, SNRM_STEPS=4)
    seine = {"BM25": {"P@5": 0.5, "P@10": 0.5, "MAP": 0.2}}
    out = cs.phase11(0, torch.device("cpu"), cs.build_corpus(0), seine)
    assert set(out["metrics"]) == set(cs.SNRM_METRICS)
    assert all(0.0 <= v <= 1.0 for v in out["metrics"].values())
    assert 0.0 < out["density"] <= 1.0
    assert len(out["losses"]) == 4 and out["first_step_err"] < 1e-9


def test_lm_train_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """Phase 12 (LM training) at smoke configs in bf16: the backward
    kernel's check and timing at small shapes, the stablelm run with its
    first step against the plain attention and its launches per step
    (forward and recompute, backward, per layer), the MoE steps, the
    bf16 checkpoint's resume bitwise and the kernels-line row."""
    from repro_torch import configs
    from repro_torch.launch import train as train_cli

    cs = _load_script()
    stable = dataclasses.replace(smoke("stablelm-1.6b"), dtype="bfloat16")
    moe = dataclasses.replace(smoke("granite-moe-3b-a800m"),
                              dtype="bfloat16")
    arch = {"stablelm-1.6b": stable, "granite-moe-3b-a800m": moe}
    monkeypatch.setattr(configs, "get_lm_config", arch.__getitem__)
    monkeypatch.setattr(cs, "get_lm_config", arch.__getitem__)
    monkeypatch.setattr(train_cli, "LM_BATCH", {True: (8, 64),
                                                False: (2, 70)})
    for name, value in dict(
            FA_BWD_SHAPES=((2, 70, 4, 4, 16, True), (1, 130, 4, 2, 32, True),
                           (1, 65, 4, 1, 16, False)),
            FA_BWD_F32_SHAPES=((2, 70, 2, 2, 32, False),
                               (1, 130, 6, 2, 32, True)),
            TRAIN_LM_STEPS=3, MOE_TRAIN_BATCH=(2, 40),
            LM_TRAIN_DIR=str(tmp_path / "lm")).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "events_ms", _host_ms)
    monkeypatch.setattr(cs, "device_profile", lambda fns, iters: None)
    monkeypatch.setattr(cs, "device_busy", _busy)
    monkeypatch.setattr(cs, "kernel_split", lambda run, n: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for name in ("flash_attn_kernel", "flash_attn_bwd_kernel"):
        monkeypatch.setattr(fa_ops, name, _counting(getattr(cs, name)))
    out = cs.phase12(0, torch.device("cpu"))
    row = out["row"]
    assert set(row) >= KEYS
    assert row["name"] == "flash_attn_bwd" and row["route"] == "cuda"
    assert row["source"] == \
        "src/repro_torch/kernels/flash_attn/csrc/flash_attn_bwd.cu"
    assert row["replaces"] == "src/repro/models/layers.py:166"
    assert row["launches"] == 3 * stable.n_layers
    assert row["launches_per_step"] == stable.n_layers
    assert out["lm"]["per_step"]["flash_attn"] == 2 * stable.n_layers
    assert row["max_abs_err"] == row["f32_max_abs_err"] == 0.0
    assert row["bound_ms"] > 0 and row["library_ms"] > 0
    assert row["plain_ms"] > 0 and row["f32_bound_ms"] > 0
    assert row["design_bound_ms"] == pytest.approx(2 * row["bound_ms"]) \
        or row["bound_by"] == "bytes"
    assert row["mirror_max_abs_err"] >= 0
    assert len(row["by_shape"]) == 3
    assert all(r["design_tflops"] == pytest.approx(2 * r["tflops"])
               for r in row["by_shape"])
    lm = out["lm"]
    assert np.isfinite(lm["losses"]).all() and len(lm["losses"]) == 3
    assert lm["p95_ms"] >= lm["p50_ms"] > 0 and 0 < lm["mfu"]
    assert lm["peak_bytes"] is None
    assert out["moe"]["router_grad_norm"] > 0 and out["moe"]["aux"] > 0
    assert len(out["moe"]["losses"]) == 2
    assert np.isfinite(out["resume"]["loss"])
    assert not os.path.exists(tmp_path / "lm")


def test_refuses_to_run_without_cuda():
    """No card: a non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout


def test_recsys_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """Phase 13 (the recsys models and MACE) at the smoke configs: the
    kernels' check and timing at a small non-causal hd-32 shape, each
    arch served (a batch of 16, 300 candidates in chunks of 128) and
    trained (its first step against the CPU and BERT4Rec's against the
    plain attention, launches per step), MACE's equivariance and steps,
    both CLIs resumed bitwise (under torch's deterministic mode, as the
    CPU otherwise sums gathers' gradients with atomics), and the two
    rows of the kernels line."""
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig

    cs = _load_script()
    shapes = {"serve_p99": ShapeConfig(name="serve_p99",
                                       kind="online-inference", batch=16),
              "retrieval_cand": ShapeConfig(name="retrieval_cand",
                                            kind="retrieval-scoring",
                                            batch=1, n_candidates=300)}
    monkeypatch.setattr(cs, "recsys_config", configs.smoke)
    monkeypatch.setattr(cs, "mace_config", lambda: configs.smoke("mace"))
    monkeypatch.setattr(cs, "served_shape", lambda arch, name: shapes[name])
    monkeypatch.setattr(cs, "mace_dims", lambda: (4, 10, 24))
    for name, value in dict(
            B4R_FA_SHAPE=(2, 70, 2, 2, 32, False),
            RECSYS_TRAIN_BATCH={"autoint": 64, "dlrm-mlperf": 64,
                                "sasrec": 8, "bert4rec": 8},
            RECSYS_TRAIN_STEPS=3, MACE_STEPS=3, RECSYS_SERVE_CALLS=2,
            RECSYS_CAND_CHUNK=128, RECSYS_CHECK_ROWS=10,
            RECSYS_DIR=str(tmp_path / "recsys")).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "events_ms", _host_ms)
    monkeypatch.setattr(cs, "device_ms",
                        lambda fns, iters, kernel, cold=False: None)
    monkeypatch.setattr(cs, "device_profile", lambda fns, iters: None)
    monkeypatch.setattr(cs, "device_busy", _busy)
    monkeypatch.setattr(cs, "kernel_split", lambda run, n: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    for name in ("flash_attn_kernel", "flash_attn_bwd_kernel"):
        monkeypatch.setattr(fa_ops, name, _counting(getattr(cs, name)))
    torch.use_deterministic_algorithms(True)
    try:
        out = cs.phase13(0, torch.device("cpu"))
    finally:
        torch.use_deterministic_algorithms(False)
    fwd, bwd = out["rows"]
    for row in (fwd, bwd):
        assert set(row) >= KEYS and row["route"] == "cuda"
        assert row["max_abs_err"] == 0.0 and row["bound_ms"] > 0
        assert row["library_ms"] > 0 and row["plain_ms"] > 0
        assert row["shape"] == [2, 70, 2, 2, 32, False]
    assert fwd["name"] == "flash_attn_bert4rec"
    assert fwd["replaces"] == "src/repro/kernels/flash_attn/kernel.py:63"
    assert bwd["name"] == "flash_attn_bwd_bert4rec"
    assert bwd["source"] == \
        "src/repro_torch/kernels/flash_attn/csrc/flash_attn_bwd.cu"
    n_blocks = configs.smoke("bert4rec").n_blocks
    # 2 timed serving calls per shape, then 3 training steps
    assert fwd["launches_by_path"] == dict(serve=2 * 2 * n_blocks,
                                           train=3 * n_blocks)
    assert fwd["launches"] == 4 * n_blocks + 3 * n_blocks
    assert bwd["launches"] == 3 * n_blocks
    assert fwd["launches_per_step"] == bwd["launches_per_step"] == n_blocks
    recsys = out["recsys"]
    assert set(recsys) == set(cs.RECSYS_ARCHS)
    for arch, r in recsys.items():
        assert set(r["serve"]) == set(cs.RECSYS_SHAPES_SERVED)
        assert len(r["train"]["losses"]) == 3
        assert r["train"]["loss_after"] < r["train"]["loss_before"]
        assert r["train"]["cpu_err"] == 0.0
        assert (r["train"]["plain_err"] is not None) == (arch == "bert4rec")
    assert recsys["sasrec"]["train"]["per_step"] == {}
    mace = out["mace"]
    assert len(mace["losses"]) == 3 and max(mace["equivariance"]) < 1e-4
    assert mace["cpu_err"] == 0.0 and mace["f32_rel"] < cs.MACE_F32_REL
    assert mace["loss_after"] < mace["loss_before"]
    assert set(out["cli"]) == set(cs.RECSYS_ARCHS) | {"gnn"}
    assert out["cli"]["bert4rec"]["launches"]["flash_attn"] > 0
    assert not os.path.exists(tmp_path / "recsys")


def test_recsys_phase_is_wired_in():
    """Phase 13 runs after phase 12 in ``main``, its rows join the
    kernels line, and its shapes are the published ones: BERT4Rec's
    attention in both float32 sweeps, the served and trained shapes of
    configs/base.py."""
    from repro_torch import configs

    cs = _load_script()
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    main = src[src.index("def main() -> int:"):]
    assert main.index("phase12(") < main.index("phase13(") \
        < main.index('json.dumps({"kernels"')
    assert 'kernels += phase13(args.seed, dev)["rows"]' in main
    assert cs.B4R_FA_SHAPE == (256, 200, 2, 2, 32, False)
    assert cs.B4R_FA_SHAPE in cs.FA_SWEEP
    assert cs.B4R_FA_SHAPE in cs.FA_BWD_F32_SHAPES
    assert cs.FA_BWD_F32_SHAPES[1] == (32, 512, 24, 8, 128, True)
    b4r = configs.get_bundle("bert4rec").config
    assert cs.B4R_FA_SHAPE[1:5] == (b4r.seq_len, b4r.n_heads, b4r.n_heads,
                                    b4r.embed_dim // b4r.n_heads)
    assert cs.RECSYS_ARCHS == ("autoint", "dlrm-mlperf", "sasrec",
                               "bert4rec")
    assert cs.RECSYS_TRAIN_BATCH["autoint"] == \
        cs.served_shape("autoint", "serve_p99").batch * 128 == \
        configs.RECSYS_SHAPES[0].batch
    assert cs.served_shape("sasrec", "retrieval_cand").n_candidates \
        == 1_000_000
    assert cs.mace_dims() == (128, 30, 64)
    full = cs.recsys_config("dlrm-mlperf")
    assert full.bot_mlp == configs.get_bundle("dlrm-mlperf").config.bot_mlp
    assert full.embed_dim == 128 and max(full.vocab_sizes) <= 100
    assert cs.mace_config() == configs.get_bundle("mace").config
