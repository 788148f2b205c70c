"""The port's launch tools (``launch/steps.py``, ``roofline.py``,
``dryrun.py``, ``report.py``) held against the JAX package's on the CPU.

* Every one of the 42 cells has the reference's ``kind``, ``step_name``
  and ``meta`` (JAX ``build_cell`` on a 1 x 1 host mesh), and its
  arguments the shapes and dtypes of the reference's
  ``ShapeDtypeStruct``s.  The reference's LM parameter shapes are traced
  once per config from a one-layer init and stacked (a full trace of
  moonshot's init alone takes a minute); ``n_params`` and the rest of
  ``meta`` come from the config, as in the reference.
* At smoke size, through ``configs.smoke`` and the private builders, each
  step kind's ``fn`` against the JAX cell's ``fn`` under ``jax.jit`` on
  the same inputs, weights carried across by ``convert``: forward outputs
  at rtol 1e-4 / atol 1e-5; training steps held as
  ``tests/test_torch_recsys.py::test_train_recsys_steps_match_jax`` holds
  them (the port's loss and every gradient against the reference's at
  its own parameters, then the port's step run on the reference's
  gradients gives the reference's next parameters and moments, and its
  loss and grad norm; for one microbatch the reference's gradients come
  from the same jitted function as its step); SEINE's M bitwise.
* ``model_flops`` and both ``report`` tables equal the reference's on the
  same records; ``run_cell(device="meta")`` of a smoke cell writes a JSON
  the port's ``report`` renders, its flops within 1% of an analytic
  count; the memo of the counting pass changes no count; the CLI's
  refusals.
"""
import dataclasses
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import train as jax_train
from repro.ckpt.checkpoint import _flatten_with_paths as jax_flatten
from repro.configs import smoke as jax_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.core import index as jax_index_mod
from repro.launch import report as jax_report
from repro.launch import roofline as jax_roofline
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import mace as JM
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch import tree as TT
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import (interaction_params_from_jax,
                                 lm_params_from_numpy,
                                 mace_params_from_numpy,
                                 recsys_params_from_numpy)
from repro_torch.kernels.embed_bag.kernel import embed_bag_plain
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch import steps as S
from repro_torch.train import adam
from torch_helpers import export
import torch_threads  # noqa: F401  (PyTorch threads per test process)

F32 = dict(rtol=1e-4, atol=1e-5)
FWD = dict(rtol=1e-5, atol=1e-6)      # knrm_pool's bar: the KNRM scores
_JAX_INIT = JT.init_params


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _port_flat(x, path=""):
    """[(name, leaf)] of a port argument tree in the reference's order
    and with its names: dict keys sorted, list and tuple items by index,
    a named tuple's or a dataclass's array fields as ``.field``."""
    if isinstance(x, torch.Tensor):
        return [(path, x)]
    join = lambda k: f"{path}/{k}" if path else str(k)
    if dataclasses.is_dataclass(x) or hasattr(x, "_fields"):
        names = ([f.name for f in dataclasses.fields(x)]
                 if dataclasses.is_dataclass(x) else x._fields)
        return [leaf for n in names
                for leaf in _port_flat(getattr(x, n), join(f".{n}"))]
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _port_flat(x[k], join(k))]
    if isinstance(x, (list, tuple)):
        return [leaf for i, v in enumerate(x)
                for leaf in _port_flat(v, join(i))]
    return []


@functools.lru_cache(maxsize=None)
def _one_layer_shapes(name: str):
    cfg = JS.get_bundle(name).config
    return jax.eval_shape(lambda: _JAX_INIT(
        dataclasses.replace(cfg, n_layers=1), jax.random.key(0)))


def _stacked_init(cfg, key):
    """The reference's init_params with the shapes of a one-layer trace,
    the stacked leaves widened to the config's layers (zeros)."""
    one = _one_layer_shapes(cfg.name)

    def full(path, s):
        lead = (cfg.n_layers,) if path[0].key == "layers" else ()
        return jnp.zeros(lead + s.shape[len(lead):], s.dtype)
    return jax.tree_util.tree_map_with_path(full, one)


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(1, 1)


@pytest.mark.parametrize("cell_id", S.all_cell_ids(),
                         ids=lambda c: "/".join(c))
def test_cell_matches_the_reference_cell(cell_id, mesh, monkeypatch):
    """kind, step_name and meta equal; every argument's shape and dtype
    equal to the reference's ``ShapeDtypeStruct`` (nothing is left out:
    the reference's padding of MACE's graphs to 512 is kept, and no
    other argument is mesh-padded)."""
    monkeypatch.setattr(JT, "init_params", _stacked_init)
    arch, shape = cell_id
    with jax.set_mesh(mesh):
        ref = JS.build_cell(arch, shape, mesh)
    cell = S.build_cell(arch, shape)
    assert (cell.kind, cell.step_name) == (ref.kind, ref.step_name)
    assert cell.meta == ref.meta
    assert cell.donate == ref.donate
    want = jax_flatten(ref.args)
    got = _port_flat(cell.args)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert a.device.type == "meta", n
        assert (tuple(a.shape), _dtype(a)) == (tuple(b.shape),
                                               str(b.dtype)), n
    assert [c.multiplier for c in cell.components] == (
        [cell.meta["accum"] - 1] if cell.meta.get("accum", 1) > 1 else [])


def test_model_flops_match_the_reference():
    for arch, shape in S.all_cell_ids():
        cell = S.build_cell(arch, shape)
        assert roofline.model_flops(cell.meta, cell.kind) == \
            jax_roofline.model_flops(cell.meta, cell.kind)


# ---------------------------------------------------------------------------
# step functions at smoke size against the reference's under jax.jit
# ---------------------------------------------------------------------------

def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _trees_close(got, want, tol=F32, scaled=False):
    """Leaf by leaf (names from the reference's tree); with ``scaled``
    each leaf's atol is relative to its largest entry, as
    ``tests/test_torch_mace.py`` holds MACE's gradients."""
    w = jax_flatten(want)
    g = TT.flatten_with_paths(got)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (n, a), (_, b) in zip(g, w):
        b = _np(b)
        top = max(float(np.abs(b).max(initial=0.0)), 1.0) if scaled else 1.0
        np.testing.assert_allclose(_np(a), b, rtol=tol["rtol"],
                                   atol=tol["atol"] * top, err_msg=n)


def _reference_step(ref_fn, jloss, args, microbatches):
    """The JAX cell's step under ``jax.jit`` and, in the same jitted
    function (one compile for the two), ``jax.value_and_grad(jloss)`` at
    its parameters on each of ``microbatches(batch)``: (the step's
    outputs, [(loss, grads)] in order)."""
    def both(p, o, b):
        return ref_fn(p, o, b), [jax.value_and_grad(jloss)(p, mb)
                                 for mb in microbatches(b)]
    return jax.jit(both)(*args)


def _reference_grads(monkeypatch, jvgs, to_port, scaled=False):
    """Route the port cell's ``value_and_grad`` through the reference:
    the i-th call checks the port's loss and every gradient against the
    reference's i-th ``(loss, grads)`` (same parameters, same batch), then
    returns the reference's, so the port's update is taken from the
    reference's own state.  Returns the calls' record."""
    real = S.value_and_grad
    calls = []

    def vg(loss_fn, params, batch):
        jl, jg = jvgs[len(calls)]
        loss, grads = real(loss_fn, params, batch)
        np.testing.assert_allclose(float(loss), float(jl), **F32)
        _trees_close(grads, jg, scaled=scaled)
        calls.append(1)
        return torch.tensor(float(jl)), to_port(jg)

    monkeypatch.setattr(S, "value_and_grad", vg)
    return calls


def _opt_close(got, want, scaled=False):
    assert int(got["step"]) == int(want["step"])
    _trees_close(got["mu"], want["mu"], scaled=scaled)
    _trees_close(got["nu"], want["nu"], scaled=scaled)


def _lm(name="stablelm-1.6b"):
    jc, c = jax_smoke(name), configs.smoke(name)
    jp = _JAX_INIT(jc, jax.random.key(0))
    to_port = lambda tree: lm_params_from_numpy(
        jax.tree.map(np.asarray, tree), c, device="cpu")
    return jc, c, jp, to_port


def _lm_tokens(vocab, shape, seed):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, vocab, shape[:-1] + (shape[-1] + 1,))
    labels = t[..., 1:].copy()
    labels[rng.rand(*labels.shape) < 0.2] = -1
    return t[..., :-1].astype(np.int32), labels.astype(np.int32)


def test_lm_train_step_matches_jax(mesh, monkeypatch):
    """stablelm's smoke config, 2 layers, (4, 32) in 2 microbatches."""
    jc, c, jp, to_port = _lm()
    sh = dict(name="train_4k", kind="training", seq_len=32, global_batch=4)
    with jax.set_mesh(mesh):
        ref = JS._lm_train_cell(jc, JShape(**sh), mesh, accum=2)
    cell = S._lm_train_cell(c, ShapeConfig(**sh), accum=2)
    assert cell.meta == ref.meta and cell.meta["accum"] == 2
    toks, labels = _lm_tokens(c.vocab_size, (2, 2, 32), 1)
    jo = jax_train.adam(3e-4).init(jp)
    ce = cell.meta["ce_chunks"]
    jloss = lambda p, b: JT.lm_loss(p, b, jc, attn_chunk=1024, ce_chunks=ce,
                                    remat=True, scan_layers=True)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    with jax.set_mesh(mesh):
        jp_next, jo_next, jm = jax.jit(ref.fn)(jp, jo, jb)
    jvg = jax.jit(jax.value_and_grad(jloss))
    jvgs = [jvg(jp, {k: v[i] for k, v in jb.items()}) for i in range(2)]
    calls = _reference_grads(monkeypatch, jvgs, to_port)
    p = to_port(jp)
    p_next, o_next, m = cell.fn(p, adam(3e-4).init(p), {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert len(calls) == 2
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **F32)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               **F32)
    _trees_close(p_next, jp_next)
    _opt_close(o_next, jo_next)


def test_lm_prefill_step_matches_jax(mesh):
    jc, c, jp, to_port = _lm()
    sh = dict(name="prefill_32k", kind="inference-prefill", seq_len=40,
              global_batch=2)
    with jax.set_mesh(mesh):
        ref = JS._lm_prefill_cell(jc, JShape(**sh), mesh)
        toks, _ = _lm_tokens(c.vocab_size, (2, 40), 2)
        want = jax.jit(ref.fn)(jp, jnp.asarray(toks))
    cell = S._lm_prefill_cell(c, ShapeConfig(**sh))
    got = cell.fn(to_port(jp), torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_lm_decode_step_matches_jax(mesh):
    """A cache of random keys and values, every row at length S - 1."""
    jc, c, jp, to_port = _lm("granite-moe-3b-a800m")
    sh = dict(name="decode_32k", kind="inference-decode", seq_len=24,
              global_batch=3)
    rng = np.random.RandomState(3)
    cache_sh = (c.n_layers, 3, 24, c.n_kv_heads, c.head_dim)
    k, v = (rng.randn(*cache_sh).astype(np.float32) for _ in range(2))
    length = np.full(3, 23, np.int32)
    toks = rng.randint(0, c.vocab_size, 3).astype(np.int32)
    with jax.set_mesh(mesh):
        ref = JS._lm_decode_cell(jc, JShape(**sh), mesh)
        jl, jcache = jax.jit(ref.fn)(jp, JT.KVCache(
            jnp.asarray(k), jnp.asarray(v), jnp.asarray(length)),
            jnp.asarray(toks))
    cell = S._lm_decode_cell(c, ShapeConfig(**sh))
    logits, cache = cell.fn(to_port(jp), S.T.KVCache(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(length)),
        torch.from_numpy(toks))
    np.testing.assert_allclose(_np(logits), _np(jl), **F32)
    np.testing.assert_allclose(_np(cache.k), _np(jcache.k), **F32)
    np.testing.assert_allclose(_np(cache.v), _np(jcache.v), **F32)
    np.testing.assert_array_equal(cache.length.numpy(), np.asarray(
        jcache.length))


def test_mace_train_step_matches_jax(mesh, monkeypatch):
    """The smoke MACE on 3 molecules of 6 atoms, padded to 512 nodes and
    edges as the reference pads them."""
    jc, c = jax_smoke("mace"), configs.smoke("mace")
    sh = dict(name="molecule", kind="batched-small-graphs", n_nodes=6,
              n_edges=10, n_graphs=3)
    with jax.set_mesh(mesh):
        ref = JS._mace_cell(jc, JShape(**sh), mesh)
    cell = S._mace_cell(c, ShapeConfig(**sh))
    assert cell.meta == ref.meta and cell.meta["n_nodes"] == 512
    b = S._mace_batch(c, ShapeConfig(**sh), 512, 512, 4)
    jp = JM.init_params(jc, jax.random.key(1))
    jo = jax_train.adam(1e-3).init(jp)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    to_port = lambda tree: mace_params_from_numpy(
        jax.tree.map(np.asarray, tree), c, device="cpu")
    jloss = lambda p, bb: JM.mace_loss(p, jc, bb, n_graphs=3)
    with jax.set_mesh(mesh):
        (jp_next, jo_next, jm), jvgs = _reference_step(
            ref.fn, jloss, (jp, jo, jb), lambda b: [b])
    _reference_grads(monkeypatch, jvgs, to_port, scaled=True)
    p = to_port(jp)
    p_next, o_next, m = cell.fn(p, adam(1e-3).init(p), {
        k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **F32)
    _trees_close(p_next, jp_next)
    _opt_close(o_next, jo_next, scaled=True)


RECSYS_SHAPES = {
    "train_batch": dict(name="train_batch", kind="training", batch=8),
    "serve_p99": dict(name="serve_p99", kind="online-inference", batch=8),
    "serve_bulk": dict(name="serve_bulk", kind="offline-scoring", batch=16),
    "retrieval_cand": dict(name="retrieval_cand", kind="retrieval-scoring",
                           batch=1, n_candidates=300),
}
JAX_RECSYS_INIT = {"attn-ctr": JR.autoint_init, "dlrm": JR.dlrm_init,
                   "seq-rec": JR.seqrec_init}


def _jax_recsys_loss(jc):
    if jc.family == "attn-ctr":
        return lambda p, b: JR.bce_loss(
            JR.autoint_forward(p, jc, b["sparse_ids"]), b["label"])
    if jc.family == "dlrm":
        return lambda p, b: JR.bce_loss(
            JR.dlrm_forward(p, jc, b["dense"], b["sparse_ids"]), b["label"])
    if jc.causal:
        return lambda p, b: JR.sasrec_loss(p, jc, b)
    return lambda p, b: JR.bert4rec_loss(p, jc, b)


@pytest.mark.parametrize("arch", ["autoint", "bert4rec"])
@pytest.mark.parametrize("shape", list(RECSYS_SHAPES))
def test_recsys_steps_match_jax(arch, shape, mesh, monkeypatch):
    """A CTR and a sequence family: the training step and the three
    serving kinds (a batch, a bulk batch, one context against 300
    candidates)."""
    jc, c = jax_smoke(arch), configs.smoke(arch)
    sh = RECSYS_SHAPES[shape]
    with jax.set_mesh(mesh):
        ref = JS._recsys_cell(jc, JShape(**sh), mesh)
    cell = S._recsys_cell(c, ShapeConfig(**sh))
    assert (cell.kind, cell.step_name, cell.meta) == (ref.kind,
                                                      ref.step_name, ref.meta)
    jp = JAX_RECSYS_INIT[jc.family](jc, jax.random.key(2))
    to_port = lambda tree: recsys_params_from_numpy(
        jax.tree.map(np.asarray, tree), c, device="cpu")
    x = S.recsys_inputs(c, ShapeConfig(**sh), 5, "cpu")
    jx = {k: jnp.asarray(v.numpy()) for k, v in x.items()}
    if sh["kind"] != "training":
        with jax.set_mesh(mesh):
            want = jax.jit(ref.fn)(jp, jx)
        got = cell.fn(to_port(jp), x)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        return
    jo = jax_train.adam(1e-3).init(jp)
    with jax.set_mesh(mesh):
        (jp_next, jo_next, jm), jvgs = _reference_step(
            ref.fn, _jax_recsys_loss(jc), (jp, jo, jx), lambda b: [b])
    _reference_grads(monkeypatch, jvgs, to_port)
    p = to_port(jp)
    p_next, o_next, m = cell.fn(p, adam(1e-3).init(p), x)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **F32)
    _trees_close(p_next, jp_next)
    _opt_close(o_next, jo_next)


def test_seine_build_step_matches_jax(mesh):
    """The build step on 4 docs of 96 slots (20 segments, 40 terms a
    doc, vocabulary 300, De 32) at seg_interact's bar."""
    docs = S.build_docs(4, 6, vocab=300, lp=96, n_b=S.SEINE_NB, u=40)
    rng = np.random.RandomState(6)
    table = (rng.randn(300, 32) / np.sqrt(32)).astype(np.float32)
    idf = (rng.rand(300) * 5).astype(np.float32)
    from repro.core.interactions import init_interaction_params
    jip = init_interaction_params(jax.random.key(7), 32)
    with jax.set_mesh(mesh):
        ref = [c for c in JS._seine_cells(mesh)
               if c.shape_name == "index_build"][0]
        want = jax.jit(ref.fn)(jnp.asarray(table), jnp.asarray(idf), jip,
                               *(jnp.asarray(docs[k]) for k in
                                 ("tokens", "segs", "uniq")))
    cell = S.build_cell("seine", "index_build")
    got = cell.fn(torch.from_numpy(table), torch.from_numpy(idf),
                  interaction_params_from_jax(jip, device="cpu"),
                  *(torch.from_numpy(docs[k]) for k in
                    ("tokens", "segs", "uniq")))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_seine_retrieve_step_matches_jax(tmp_path, mesh):
    """KNRM over a 300-doc Zipfian index (n_b 4): M bitwise, the scores
    at knrm_pool's bar; the query mixes the hot term, tail terms, a term
    past the vocabulary and a pad slot."""
    from repro.data.synth_corpus import build_zipfian_index
    from repro.retrievers import get_retriever as jax_retriever

    jidx = build_zipfian_index(n_docs=300, vocab=50, n_b=4, tail_decay=0.7,
                               seed=3)
    idx = export(jidx, tmp_path / "idx")
    q = np.array([0, 1, 7, 20, 49, 60, -1, 3], np.int32)
    docs = np.arange(0, jidx.n_docs, 3).astype(np.int32)
    jk = jax_retriever("knrm").init(jax.random.key(8), jidx.n_b,
                                    jidx.functions)
    kp = {k: torch.from_numpy(np.array(v)) for k, v in jk.items()}
    with jax.set_mesh(mesh):
        ref = [c for c in JS._seine_cells(mesh)
               if c.shape_name == "retrieve"][0]
        want = jax.jit(ref.fn)(jidx, jk, jnp.asarray(q), jnp.asarray(docs))
    got = S.build_cell("seine", "retrieve").fn(
        idx, kp, torch.from_numpy(q), torch.from_numpy(docs))
    np.testing.assert_allclose(_np(got), _np(want), **FWD)
    np.testing.assert_array_equal(
        idx.qd_matrix(torch.from_numpy(q), torch.from_numpy(docs)).numpy(),
        np.asarray(jidx.qd_matrix(jnp.asarray(q), jnp.asarray(docs),
                                  impl="jnp")))
    assert isinstance(jidx, jax_index_mod.SegmentInvertedIndex)


# ---------------------------------------------------------------------------
# the counting pass, the records and the report
# ---------------------------------------------------------------------------

def _smoke_bundles(monkeypatch, seq_len=64):
    """``build_cell`` over smoke configs with small LM shapes."""
    real = S.get_bundle
    lm_shapes = (ShapeConfig(name="train_4k", kind="training",
                             seq_len=seq_len, global_batch=4),
                 ShapeConfig(name="prefill_32k", kind="inference-prefill",
                             seq_len=seq_len, global_batch=2))

    def smoke_bundle(arch):
        b = real(arch)
        shapes = lm_shapes if b.domain == "lm" else b.shapes
        return dataclasses.replace(b, config=configs.smoke(arch),
                                   shapes=shapes)
    monkeypatch.setattr(S, "get_bundle", smoke_bundle)
    monkeypatch.setattr(S, "MICROBATCH_TOKENS", 2 * seq_len)


def _prefill_flops(c, B, S_):
    """Matrix-product flops of a prefill through ``gqa_attention`` at
    chunk 1,024: the projections and the FFN over every token, QK^T and
    PV over the padded chunks, the unembedding of the last token."""
    T_ = B * S_
    hd, hq, hkv = c.head_dim, c.n_heads, c.n_kv_heads
    proj = 2 * T_ * c.d_model * (2 * hq * hd + 2 * hkv * hd)
    ffn = 2 * T_ * 3 * c.d_model * c.d_ff
    keys = math.ceil(S_ / 1024) * 1024
    attn = 2 * 2 * B * S_ * keys * hq * hd
    return c.n_layers * (proj + ffn + attn) + 2 * B * c.d_model * c.vocab_size


def test_run_cell_counts_a_smoke_cell_and_report_renders_it(monkeypatch,
                                                            tmp_path):
    """``dryrun --device meta`` of stablelm's smoke prefill writes a
    record the port's report renders; its flops within 1% of the
    analytic count."""
    _smoke_bundles(monkeypatch)
    out = tmp_path / "rec"
    assert dryrun.main(["--arch", "stablelm-1.6b", "--shape", "prefill_32k",
                        "--device", "meta", "--out", str(out)]) == 0
    rec = json.loads((out / "stablelm-1.6b__prefill_32k__card.json")
                     .read_text())
    c = configs.smoke("stablelm-1.6b")
    want = _prefill_flops(c, 2, 64)
    assert abs(rec["roofline"]["flops_per_device"] - want) <= 0.01 * want
    assert rec["on_card"] is False and rec["device"] == "meta"
    assert rec["memory"]["peak_gib_per_device"] is None
    assert rec["memory"]["argument_bytes_per_device"] == sum(
        math.prod(s) * 4 for s, _ in S.T.param_specs(c).values()) + 2 * 64 * 4
    assert rec["roofline"]["coll_by_op"] == {"total": 0.0}
    recs = report.load(str(out))
    table = report.roofline_table(recs, "card")
    assert "| stablelm-1.6b | prefill_32k | baseline | - |" in table
    assert "| stablelm-1.6b | prefill_32k | card | 1 | - |" in \
        report.dryrun_table(recs)


def test_training_components_add_up_to_the_whole_step(monkeypatch):
    """A LM training cell's count (its first microbatch with the update,
    plus accum - 1 microbatches) equals the count of the whole step over
    every microbatch, flops and bytes."""
    _smoke_bundles(monkeypatch, seq_len=32)
    cell = S.build_cell("granite-moe-3b-a800m", "train_4k")
    assert cell.meta["accum"] == 2 and len(cell.components) == 1
    rec = dryrun.run_cell("granite-moe-3b-a800m", "train_4k", device="meta",
                          verbose=False)
    whole, _ = dryrun.count(cell.fn, cell.args, cell.count_kwargs)
    assert rec["roofline"]["flops_per_device"] == whole.flops
    assert rec["roofline"]["hbm_bytes_per_device"] == whole.hbm_bytes
    assert rec["components"][0]["multiplier"] == 1


def test_memo_changes_no_count(monkeypatch):
    """The counting pass's memo against running every op: the same flops
    and bytes for a MoE training step and SEINE's build step."""
    _smoke_bundles(monkeypatch, seq_len=32)
    for arch, shape in (("granite-moe-3b-a800m", "train_4k"),
                        ("mace", "molecule")):
        cell = S.build_cell(arch, shape)
        args = cell.count_args or cell.args
        memo, _ = dryrun.count(cell.fn, args, cell.count_kwargs)
        from torch.utils.flop_counter import FlopCounterMode
        flops, moved = FlopCounterMode(display=False), dryrun.ByteCount()
        with flops, moved:
            cell.fn(*args, **cell.count_kwargs)
        assert memo.flops == flops.get_total_flops()
        assert memo.hbm_bytes == moved.bytes


def _records():
    """Records of the reference's form: counted cells with a peak, and
    one with collectives."""
    recs = []
    for i, (arch, shape) in enumerate(S.all_cell_ids()[:6]):
        cell = S.build_cell(arch, shape)
        terms = roofline.terms_from_counts(
            1e12 * (i + 1), 3e11 * (i + 2),
            {"all-reduce": 5e8 * i} if i % 2 else None)
        mf = roofline.model_flops(cell.meta, cell.kind)
        recs.append({
            "arch": arch, "shape": shape, "mesh": "single", "n_devices": 1,
            "kind": cell.kind, "step": cell.step_name, "lower_s": 1.5,
            "compile_s": 2.25 + i,
            "memory": {"argument_bytes_per_device": 10 ** (i + 3),
                       "output_bytes_per_device": 7,
                       "temp_bytes_per_device": 3 * 10 ** (i + 2),
                       "peak_gib_per_device": 0.5 * i},
            "roofline": terms.as_dict(), "components": [], "meta": cell.meta,
            "model_flops_global": mf,
            "useful_flops_ratio": mf / terms.flops if mf else None})
    return recs


def test_report_tables_match_the_reference(tmp_path):
    recs = _records()
    for r in recs:
        with open(tmp_path / f"{r['arch']}__{r['shape']}__single.json",
                  "w") as f:
            json.dump(r, f)
    assert report.load(str(tmp_path)) == jax_report.load(str(tmp_path))
    loaded = report.load(str(tmp_path))
    assert report.roofline_table(loaded) == jax_report.roofline_table(loaded)
    assert report.dryrun_table(loaded) == jax_report.dryrun_table(loaded)
    ref_terms = jax_roofline.RooflineTerms(1e12, 3e11, 5e8,
                                           {"all-reduce": 5e8})
    terms = roofline.RooflineTerms(1e12, 3e11, 5e8, {"all-reduce": 5e8})
    assert set(terms.as_dict()) == set(ref_terms.as_dict())
    assert terms.add(terms, k=3).as_dict()["coll_by_op"] == \
        ref_terms.add(ref_terms, k=3).as_dict()["coll_by_op"]
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == (
        989e12, 3.35e12, 450e9)


def test_cli_refuses_without_a_card_and_counts_on_a_mesh(capsys,
                                                          monkeypatch,
                                                          tmp_path):
    """Without a card ``--device cuda`` is refused; ``--mesh multi
    --device meta`` counts MACE's molecule cell in a worker process on a
    fake world of 512 ranks: one device's record, with its collectives
    (the edges and nodes are split over the whole mesh)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun.main(["--arch", "yi-9b", "--shape", "train_4k"]) != 0
    assert "needs a card" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="needs a card"):
        dryrun.run_cell("yi-9b", "train_4k", device="cuda")
    assert dryrun.main(["--arch", "mace", "--shape", "molecule", "--mesh",
                        "multi", "--device", "meta", "--out",
                        str(tmp_path), "--quiet"]) == 0
    rec = json.loads((tmp_path / "mace__molecule__multi.json").read_text())
    assert rec["n_devices"] == 512 and rec["mesh"] == "multi"
    coll = rec["roofline"]["coll_by_op"]
    assert coll["total"] > 0 and set(coll) - {"total"}
    assert rec["on_card"] is False and rec["memory"]["peak_gib_per_device"] \
        is None


def _embed_bag_passes(table, indices, bag_ptr):
    """``embed_bag_plain`` before it took a static bound: one pass per
    rank, as many passes as the longest bag, read from the host."""
    n_rows, d = table.shape
    n_bags = bag_ptr.shape[0] - 1
    out = torch.zeros((n_bags, d), dtype=table.dtype)
    ptr_ = bag_ptr.long()
    pos = torch.arange(indices.shape[0])
    bag = torch.searchsorted(ptr_[1:], pos, right=True)
    keep = (indices >= 0) & (pos >= ptr_[0]) & (bag < n_bags)
    bag, pos = bag[keep], pos[keep]
    rows = indices[keep].long().clamp(max=n_rows - 1)
    rank = pos - ptr_[bag]
    order = torch.argsort(rank, stable=True)
    bag, rows = bag[order], rows[order]
    start = 0
    for count in torch.bincount(rank).tolist():
        b = bag[start:start + count]
        out[b] = out[b] + table[rows[start:start + count]]
        start += count
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_embed_bag_plain_keeps_its_bits(dtype):
    """The static-shaped plain version (passes up to a bound, no host
    read) bitwise its data-dependent form, with empty bags, -1 rows, rows
    past the table and a bound past the longest bag; and it runs on meta
    tensors."""
    rng = np.random.RandomState(9)
    table = torch.from_numpy(rng.randn(50, 24).astype(np.float32)).to(dtype)
    sizes = rng.randint(0, 9, 40)
    sizes[[3, 17]] = 0
    ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])
                           ).to(torch.int32)
    idx = torch.from_numpy(rng.randint(-1, 55, int(sizes.sum()))
                           ).to(torch.int32)
    want = _embed_bag_passes(table, idx, ptr)
    for bound in (None, int(sizes.max()), 12):
        got = embed_bag_plain(table, idx, ptr, max_bag=bound)
        assert torch.equal(got.view(torch.int16) if dtype == torch.bfloat16
                           else got, want.view(torch.int16)
                           if dtype == torch.bfloat16 else want)
    on_meta = embed_bag_plain(table.to("meta"), idx.to("meta"),
                              ptr.to("meta"), max_bag=8)
    assert on_meta.shape == want.shape and on_meta.device.type == "meta"


def test_segment_one_hots_keep_their_numbers():
    """The comparisons that replaced ``F.one_hot`` (a host read on meta
    tensors) in ``doc_interactions`` and ``HashProvider.contextualize``
    give its values, out-of-range bins masked as before."""
    seg = torch.from_numpy(np.random.RandomState(10).randint(0, 21,
                                                             (3, 40)))
    assert torch.equal((seg[..., None] == torch.arange(21)).float(),
                       F.one_hot(seg, 21).float())
    bins = seg.clamp(0, 63)
    in_range = seg < 15
    assert torch.equal(
        ((bins[..., None] == torch.arange(64)) & in_range[..., None]).float(),
        (F.one_hot(bins, 64) * in_range[..., None]).float())
    assert os.path.basename(dryrun.OUT_DIR) == "dryrun_results_torch"
