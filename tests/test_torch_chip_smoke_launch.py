"""``chip_smoke.py`` phase 14 (the launch tools) rehearsed on the CPU.

Every cell is counted on the meta device in the test's process, with the
smoke config of each architecture at small shapes of the same names; the
five stepped cells run on the CPU through ``launch.dryrun.run_cell``
(SEINE's build at 4 docs of 160 slots), ``seine/retrieve``'s step over a 1,500-doc phase 1 index
(the Zipfian world of ``test_phases_run_on_the_cpu``) against
``SeineEngine.score`` bitwise, with the kernels' names wrapped in launch
counters (their plain versions run), and the flash_attn check at a
small stand-in for prefill_32k's shape.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import interactions
from repro_torch.kernels.csr_lookup import ops as lookup_ops
from repro_torch.kernels.embed_bag import ops as eb_ops
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.knrm_pool import ops as knrm_ops
from repro_torch.kernels.seg_interact import ops as seg_ops
from repro_torch.launch import steps as S
from torch_chip_smoke_helpers import (_counting, _counting_segments,
                                      _load_script)
import torch_threads  # noqa: F401  (PyTorch threads per test process)

LM_SHAPES = (
    ShapeConfig(name="train_4k", kind="training", seq_len=32, global_batch=4),
    ShapeConfig(name="prefill_32k", kind="inference-prefill", seq_len=48,
                global_batch=2),
    ShapeConfig(name="decode_32k", kind="inference-decode", seq_len=40,
                global_batch=2),
    ShapeConfig(name="long_500k", kind="long-context-decode", seq_len=96,
                global_batch=1))
GNN_SHAPES = (
    ShapeConfig(name="full_graph_sm", kind="full-batch", n_nodes=50,
                n_edges=120),
    ShapeConfig(name="minibatch_lg", kind="sampled-training", batch_nodes=8,
                fanout=(2, 2)),
    ShapeConfig(name="ogb_products", kind="full-batch-large", n_nodes=90,
                n_edges=300),
    ShapeConfig(name="molecule", kind="batched-small-graphs", n_nodes=6,
                n_edges=10, n_graphs=3))
RECSYS_SHAPES = (
    ShapeConfig(name="train_batch", kind="training", batch=64),
    ShapeConfig(name="serve_p99", kind="online-inference", batch=16),
    ShapeConfig(name="serve_bulk", kind="offline-scoring", batch=32),
    ShapeConfig(name="retrieval_cand", kind="retrieval-scoring", batch=1,
                n_candidates=300))
SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}


def _smoke_cells(monkeypatch):
    real = S.get_bundle

    def bundle(arch):
        b = real(arch)
        return dataclasses.replace(b, config=configs.smoke(arch),
                                   shapes=SHAPES[b.domain])
    monkeypatch.setattr(S, "get_bundle", bundle)
    monkeypatch.setattr(S, "MICROBATCH_TOKENS", 64)
    for name, value in dict(SEINE_BUILD_DOCS=4, SEINE_V=2000, SEINE_DE=32,
                            SEINE_LP=160, SEINE_U=64).items():
        monkeypatch.setattr(S, name, value)


def test_launch_phase_runs_on_the_cpu(monkeypatch):
    cs = _load_script()
    _smoke_cells(monkeypatch)
    for name, value in dict(N_DOCS=1500, VOCAB=3000, TAIL_DRAWS=30,
                            LAUNCH_JOBS=1, RETRIEVE_CANDS=300,
                            PREFILL_ATTN_SHAPE=(2, 70, 4, 4, 16)).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    # the kernels' wrappers for CPU tensors (their plain versions); meta
    # tensors, counted, take the torch ref lowering as on the card
    monkeypatch.setattr(lookup_ops, "_use_kernel", lambda impl, like: (
        impl in (None, "kernel") and like.device.type != "meta"))
    for mod, name in ((fa_ops, "flash_attn_kernel"),
                      (fa_ops, "flash_attn_bwd_kernel"),
                      (interactions, "seg_interact_kernel"),
                      (seg_ops, "seg_interact_kernel"),
                      (lookup_ops, "csr_lookup_kernel"),
                      (knrm_ops, "knrm_pool_kernel")):
        monkeypatch.setattr(mod, name, _counting(getattr(cs, name)))
    monkeypatch.setattr(eb_ops, "embed_bag_segment_kernel", _counting_segments(
        cs.embed_bag_segment_kernel, cs.embed_bag_kernel))

    out = cs.phase14(0, torch.device("cpu"))
    assert len(out["counted"]) == 42
    assert set(out["counted"]) == set(S.all_cell_ids())
    for rec in out["counted"].values():
        assert rec["device"] == "meta" and rec["roofline"]["flops_per_device"] >= 0
    launched = out["launches"]
    assert all(launched[k] > 0 for k in cs.LAUNCH_KERNELS), launched
    # the stablelm smoke config's train_4k: 2 microbatches, each layer's
    # forward and recompute, then one backward; its prefill one a layer;
    # the LM cells one step each, BERT4Rec's two
    n_l = configs.smoke("stablelm-1.6b").n_layers
    n_b4r = configs.smoke("bert4rec").n_blocks
    assert launched["flash_attn_bwd"] == 2 * n_l
    assert launched["flash_attn"] == 2 * 2 * n_l + n_l + 2 * n_b4r
    # the build step twice: seg_interact once, embed_bag twice a step
    assert (launched["seg_interact"], launched["embed_bag"]) == (2, 4)
    assert launched["csr_lookup"] == launched["knrm_pool"] == 1
    assert set(out["stepped"]) == set(cs.LAUNCH_STEPPED)
    for rec in out["stepped"].values():
        assert rec["step_s"] > 0 and rec["device"] == "cpu"
    assert out["attn_err"] == 0.0


def test_launch_phase_is_wired_in():
    """Phase 14 runs after phase 13, its launches join the kernels line,
    and it steps the cells one card holds at their published shapes."""
    cs = _load_script()
    with open(cs.__file__) as f:
        src = f.read()
    main = src[src.index("def main() -> int:"):]
    assert main.index("phase13(") < main.index("phase14(") \
        < main.index('json.dumps({"kernels"')
    assert cs.LAUNCH_STEPPED == (
        ("seine", "index_build"), ("bert4rec", "serve_p99"),
        ("mace", "molecule"), ("stablelm-1.6b", "prefill_32k"),
        ("stablelm-1.6b", "train_4k"))
    lm = configs.get_bundle("stablelm-1.6b")
    pre = lm.shape("prefill_32k")
    assert cs.PREFILL_ATTN_SHAPE == (
        pre.global_batch, pre.seq_len, lm.config.n_heads,
        lm.config.n_kv_heads, lm.config.head_dim)
    assert (cs.RETRIEVE_TERMS, cs.RETRIEVE_CANDS) == (S.SEINE_Q,
                                                      S.SEINE_CAND)
    assert S.lm_accum(lm.shape("train_4k")) == 64


@pytest.mark.parametrize("jobs", [2])
def test_cells_are_counted_in_worker_processes(jobs):
    """``count_cells`` in processes of the dryrun command line gives the
    records of the in-process count (two small full-size cells)."""
    from repro_torch.launch import dryrun
    cells = [("bert4rec", "serve_p99"), ("mace", "molecule")]
    par = dryrun.count_cells(cells, jobs=jobs)
    one = dryrun.count_cells(cells, jobs=1)
    assert list(par) == cells
    for c in cells:
        assert par[c]["roofline"] == one[c]["roofline"]
        assert par[c]["memory"] == one[c]["memory"]
