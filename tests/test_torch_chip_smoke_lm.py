"""``chip_smoke.py`` phases 6, 10, 11 and 12 (the LM bridge, the MoE LM
and decode, SNRM, LM training) rehearsed on the CPU at the smoke
configs, with the kernels' names wrapped in launch counters and the
card-only timing stubbed (``torch_chip_smoke_helpers``).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke
from repro_torch.core import interactions
from repro_torch.kernels.csr_lookup import ops as lookup_ops
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.knrm_pool import ops as knrm_ops
from repro_torch.kernels.seg_interact import ops as seg_ops
from torch_chip_smoke_helpers import (_load_script, _counting, _host_ms, _busy,
                                      _patch_lm, KEYS)
import torch_threads  # noqa: F401  (PyTorch threads per test process)


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
