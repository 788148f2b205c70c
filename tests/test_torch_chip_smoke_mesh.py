"""``chip_smoke.py`` phase 15 (the serving half of the mesh paths on a
1 x 1 mesh) rehearsed on the CPU at a tiny size, over gloo where the
card runs NCCL: phase 1's index at 1,500 docs served three ways on the
mesh bitwise as the mesh-less engine served it, the meshed build of 64
docs, ``sp_decode_attention`` at a smoke MoE's cache and the
reshard-on-load of a KNRM checkpoint.  The kernels' names are wrapped in
launch counters, as in the other rehearsals
(``torch_chip_smoke_helpers``).
"""
import numpy as np
import torch

from repro_torch.ckpt import save_checkpoint
from repro_torch.configs import smoke
from repro_torch.dist.sharding import partition_index
from repro_torch.kernels.csr_lookup import ops as lookup_ops
from repro_torch.kernels.knrm_pool import ops as knrm_ops
from repro_torch.retrievers import get_retriever
from repro_torch.serving import SeineEngine, serve_batches
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
