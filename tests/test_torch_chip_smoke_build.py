"""``chip_smoke.py`` phases 5, 7, 8 and 9 (the offline build, the front
end, the live index, ranker training) rehearsed on the CPU over a
hundred-odd docs, with the kernels' names wrapped in launch counters and
the card-only timing stubbed (``torch_chip_smoke_helpers``).
"""
import os

import pytest
import torch

from repro_torch.kernels.csr_lookup import ops as lookup_ops
from torch_chip_smoke_helpers import (_load_script, _counting, _patch_build,
                                      KEYS)
import torch_threads  # noqa: F401  (PyTorch threads per test process)


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
