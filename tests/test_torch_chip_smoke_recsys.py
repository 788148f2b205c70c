"""``chip_smoke.py`` phase 13 (the recsys models and MACE) rehearsed on
the CPU at the smoke configs, and its wiring into ``main``.
"""
import os

import torch

from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.launch import steps as launch_steps
from torch_chip_smoke_helpers import (_load_script, _counting, _host_ms, _busy,
                                      KEYS, REPO)
import torch_threads  # noqa: F401  (PyTorch threads per test process)


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
            RECSYS_CHECK_ROWS=10,
            RECSYS_DIR=str(tmp_path / "recsys")).items():
        monkeypatch.setattr(cs, name, value)
    # the CTR candidates in chunks of 128 (the serve step's, launch.steps)
    monkeypatch.setattr(launch_steps, "CTR_CAND_CHUNK", 128)
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
