"""``chip_smoke.py`` phase 15 (the serving half of the mesh paths on a
1 x 1 mesh) rehearsed on the CPU at a tiny size, over gloo where the
card runs NCCL: phase 1's index at 1,500 docs served three ways on the
mesh bitwise as the mesh-less engine served it, the meshed build of 64
docs, ``sp_decode_attention`` at a smoke MoE's cache and the
reshard-on-load of a KNRM checkpoint.  The kernels' names are wrapped in
launch counters, as in the other rehearsals
(``torch_chip_smoke_helpers``).
"""
import dataclasses

import numpy as np
import torch

from repro_torch.ckpt import save_checkpoint
from repro_torch.configs import smoke
from repro_torch.dist.sharding import partition_index
from repro_torch.kernels.csr_lookup import ops as lookup_ops
from repro_torch.kernels.knrm_pool import ops as knrm_ops
from repro_torch.retrievers import get_retriever
from repro_torch.serving import SeineEngine, serve_batches
from repro_torch.kernels.flash_attn import ops as fa_ops
from torch_chip_smoke_helpers import _counting, _load_script, _patch_build
import torch_threads  # noqa: F401  (PyTorch threads per test process)


def test_mesh_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    cs = _load_script()
    _patch_build(cs, monkeypatch, tmp_path)
    for name, value in dict(N_DOCS=1500, VOCAB=3000, TAIL_DRAWS=30,
                            N_CAND=120, N_REQUESTS=3, MESH_BUILD_DOCS=64,
                            DECODE_PROMPTS=3, DECODE_PROMPT_LEN=24,
                            DECODE_STEPS=8,
                            MESH_DIR=str(tmp_path / "mesh")).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "moe_config",
                        lambda: smoke("granite-moe-3b-a800m"))
    monkeypatch.setattr(cs, "nccl_kernels", lambda run: {})
    for mod, name in ((lookup_ops, "csr_lookup_kernel"),
                      (knrm_ops, "knrm_pool_kernel")):
        monkeypatch.setattr(mod, name, _counting(getattr(cs, name)))
    dev = torch.device("cpu")
    index, rng = cs.build_index(0, dev)
    pidx = partition_index(index, cs.K_SHARDS)
    params = get_retriever("knrm").init(torch.Generator().manual_seed(0),
                                        cs.N_B, index.functions,
                                        device=dev)
    requests = [(cs.draw_query(rng, 4),
                 rng.choice(cs.N_DOCS, cs.N_CAND, replace=False)
                 .astype(np.int32)) for _ in range(cs.N_REQUESTS)]
    scores, _ = serve_batches(SeineEngine(index, "knrm", params), requests)
    # phase 9's checkpoint: KNRM's parameters and an optimizer state
    save_checkpoint(str(tmp_path / "mesh" / "knrm"), 200,
                    {"params": params, "opt": {"step": torch.tensor(3)}})
    ctx = dict(index=index, pidx=pidx, requests=requests, scores=scores)
    out = cs.phase15(ctx, 0, dev, cs.build_corpus(0), "card, 700 W")
    assert set(out["serving"]) == {"single CSR", "K=4",
                                   "term, K from the mesh"}
    for run in out["serving"].values():
        for name in ("csr_lookup", "knrm_pool", "all_reduce",
                     "all_gather"):
            assert run["launches"][name] >= cs.N_REQUESTS, name
    assert out["build"]["docs"] == 64
    assert out["build"]["launches"]["seg_interact"] > 0
    assert out["decode_err"] < 1e-5
    assert out["restored"] == len(list(params.state_dict()))
    assert not (tmp_path / "mesh").exists()
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_mesh_train_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """Phase 16 at smoke configs and tiny shapes over gloo: the placed
    LM steps (fsdp and tp2d, the MoE under fsdp), MACE (``molecule`` and
    ``minibatch_lg`` cut to a small graph, each rank's nodes and edges:
    the three collectives ran), DLRM and seine/retrieve bitwise their
    mesh-less steps, the kernels' launches counted, the reshard-on-load,
    and a counted cell read back from its worker."""
    cs = _load_script()
    for name, value in dict(
            N_DOCS=1500, VOCAB=3000, TAIL_DRAWS=30, RETRIEVE_CANDS=300,
            MESH_TRAIN_SHAPE=(4, 32), MESH_MOE_SHAPE=(4, 32),
            MESH_TRAIN_STEPS=1,
            MESH_COUNTS=(("autoint", "serve_p99", "tp2d"),),
            MESH_TRAIN_DIR=str(tmp_path / "train"),
            MESH_COUNT_DIR=str(tmp_path / "count")).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "train_lm_config",
                        lambda name, n_layers=None: smoke(name))
    monkeypatch.setattr(cs, "mace_config", lambda: smoke("mace"))
    # minibatch_lg cut to 8 seeds of fanout (3, 2): 80 nodes, 72 edges
    real_shape = cs.mace_shape
    monkeypatch.setattr(cs, "mace_shape", lambda name: dataclasses.replace(
        real_shape(name), batch_nodes=8, fanout=(3, 2))
        if name == "minibatch_lg" else real_shape(name))
    monkeypatch.setattr(cs, "recsys_config", lambda arch: smoke(arch))
    monkeypatch.setitem(cs.RECSYS_TRAIN_BATCH, "dlrm-mlperf", 64)
    monkeypatch.setattr(cs, "nccl_kernels", lambda run: {})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(lookup_ops, "_use_kernel",
                        lambda impl, like: impl in (None, "kernel"))
    for mod, name in ((lookup_ops, "csr_lookup_kernel"),
                      (knrm_ops, "knrm_pool_kernel"),
                      (fa_ops, "flash_attn_kernel"),
                      (fa_ops, "flash_attn_bwd_kernel")):
        monkeypatch.setattr(mod, name, _counting(getattr(cs, name)))
    dev = torch.device("cpu")
    index, _ = cs.build_index(0, dev)
    # the card's segment sums sort their ids; the CPU's add with atomics
    # across threads unless deterministic
    torch.use_deterministic_algorithms(True)
    try:
        out = cs.phase16({"index": index}, 0, dev, "card, 700 W")
    finally:
        torch.use_deterministic_algorithms(False)
    assert set(out["lm"]) == {("stablelm-1.6b", "fsdp"),
                              ("stablelm-1.6b", "tp2d"),
                              ("granite-moe-3b-a800m", "fsdp")}
    for run in out["lm"].values():
        assert run["per_step"]["flash_attn_bwd"] == 2
    assert set(out["small"]) == {"mace/molecule", "mace/minibatch_lg",
                                 "dlrm-mlperf/train_batch"}
    for name in ("mace/molecule", "mace/minibatch_lg"):
        for coll in cs.MACE_COLLECTIVES:
            assert out["small"][name]["launches"][coll] > 0, (name, coll)
    assert out["retrieve"]["launches"]["csr_lookup"] > 0
    assert out["restored"] > 10
    rec = out["counts"]["autoint/serve_p99/tp2d"]
    assert rec["argument_bytes"] > 0 and "total" in rec["coll_by_op"]
    assert not (tmp_path / "train").exists()
    import torch.distributed as dist
    assert not dist.is_initialized()
