"""PyTorch port of the SNRM baseline indexer (``core.snrm``), held
against ``repro.core.snrm`` on the CPU.

Parameters cross from JAX through ``convert.snrm_params_from_numpy``;
inputs are the ``seine_world`` fixture's docs and queries.  Bars:
float32 rtol 1e-4 / atol 1e-5 (tests/test_kernels.py's) for encodings,
scores, the loss and its gradients (against ``jax.value_and_grad``),
and for 30 Adam steps run as tests/test_retrievers.py's SNRM test runs
them, through the port's ``train.adam`` / ``apply_updates``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snrm as JS
from repro.train import adam as jax_adam
from repro.train import apply_updates as jax_apply
from repro_torch.convert import snrm_params_from_numpy
from repro_torch.core import snrm as S
from repro_torch.train import adam, apply_updates, value_and_grad
import torch_threads  # noqa: F401  (PyTorch threads per test process)

F32 = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _params(world, seed=0, d_latent=64):
    jp = JS.init_snrm(jax.random.key(seed), world["vocab"].size,
                      d_latent=d_latent)
    return jp, snrm_params_from_numpy(jp, device="cpu")


def _batch(world, rng, n):
    """tests/test_retrievers.py's SNRM batch: a relevant and a
    non-relevant doc per sampled query."""
    qrels, queries, toks = world["ds"].qrels, world["queries"], world["toks"]
    qi = rng.randint(0, len(queries), n)
    pos, neg = [], []
    for q in qi:
        rel = np.flatnonzero(qrels[q] > 0)
        nrel = np.flatnonzero(qrels[q] == 0)
        pos.append(rel[rng.randint(rel.size)] if rel.size else 0)
        neg.append(nrel[rng.randint(nrel.size)] if nrel.size else 1)
    return {"query": queries[qi], "pos": toks[pos], "neg": toks[neg]}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_init_shapes_and_scales():
    p = S.init_snrm(5000, 128, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    jp = JS.init_snrm(jax.random.key(0), 5000, d_latent=128)
    for k in ("emb", "w1", "w2"):
        assert tuple(p[k].shape) == jp[k].shape and p[k].dtype == \
            torch.float32
        scale = p[k].shape[0] ** -0.5
        assert abs(float(p[k].std()) / scale - 1) < 0.1, k


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_and_score_match_jax(seine_world, seed):
    """Docs with pads, queries with OOV slots, and slots past the
    vocabulary (the clipping gather)."""
    w = seine_world
    jp, tp = _params(w, seed)
    toks = w["toks"][:12].copy()
    toks[0, :5] = w["vocab"].size + 7
    toks[1, :] = -1                        # an empty doc: mean over none
    got = S.encode(tp, torch.from_numpy(toks))
    want = JS.encode(jp, jnp.asarray(toks))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert bool((got[1] == 0).all())
    q = w["queries"][np.arange(12) % len(w["queries"])]
    np.testing.assert_allclose(
        _np(S.score(tp, torch.from_numpy(q), torch.from_numpy(toks))),
        _np(JS.score(jp, jnp.asarray(q), jnp.asarray(toks))), **F32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_and_gradients_match_jax(seine_world, seed):
    w = seine_world
    jp, tp = _params(w, seed)
    batch = _batch(w, np.random.RandomState(seed), 8)
    want, jg = jax.value_and_grad(JS.snrm_loss)(jp, _jnp(batch))
    got, g = value_and_grad(S.snrm_loss, tp, _torch(batch))
    np.testing.assert_allclose(float(got), float(want), **F32)
    for k in ("emb", "w1", "w2"):
        np.testing.assert_allclose(_np(g[k]), _np(jg[k]), **F32, err_msg=k)


def test_30_adam_steps_match_jax(seine_world):
    """tests/test_retrievers.py's recipe: d_latent 64, adam(1e-2), 30
    steps of 8 (q, pos, neg) triples.  Every step, from the reference's
    parameters and optimizer state, the port's loss and gradients and
    its Adam update of the reference's gradients equal the reference's
    (float32 bar).  The port's own 30 steps meet the reference's bar
    (the last loss at most the first + 1e-3).  The two runs are not
    held to each other past the first step: gradient components near
    Adam's eps (1e-8; the L1 term's are ~1e-8) carry float32 rounding
    noise of a few 1e-10 from any summation order, and Adam turns that
    into steps of up to lr, so the runs part by ~1e-3 in the loss after
    a few steps."""
    w = seine_world
    jp, tp = _params(w, 0)
    jopt, opt = jax_adam(1e-2), adam(1e-2)
    jst, st = jopt.init(jp), opt.init(tp)
    own_st = opt.init(tp)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(30):
        batch = _batch(w, rng, 8)
        jl, jg = jax.value_and_grad(JS.snrm_loss)(jp, _jnp(batch))
        ju, jst_next = jopt.update(jg, jst, jp)
        at = snrm_params_from_numpy(jp, device="cpu")
        loss, g = value_and_grad(S.snrm_loss, at, _torch(batch))
        np.testing.assert_allclose(float(loss), float(jl), **F32)
        u, st = opt.update(snrm_params_from_numpy(jg, device="cpu"), st, at)
        for k in ("emb", "w1", "w2"):
            np.testing.assert_allclose(_np(g[k]), _np(jg[k]), **F32,
                                       err_msg=k)
            np.testing.assert_allclose(_np(u[k]), _np(ju[k]), **F32,
                                       err_msg=k)
        jp, jst = jax_apply(jp, ju), jst_next
        own, og = value_and_grad(S.snrm_loss, tp, _torch(batch))
        ou, own_st = opt.update(og, own_st, tp)
        tp = apply_updates(tp, ou)
        losses.append(float(own))
    assert losses[-1] <= losses[0] + 1e-3
    ids, _ = S.latent_doc_sequences(tp, w["toks"][:10], top_k=8)
    assert ids.shape == (10, 8)


@pytest.mark.parametrize("top_k", [8, 32])
def test_latent_doc_sequences_match_jax(seine_world, top_k):
    """Strengths at the float32 bar; ids equal wherever a strength lies
    more than the bar from its neighbours in the ranking (elsewhere a
    near-tie may order either way), -1 where the strength is 0."""
    w = seine_world
    jp, tp = _params(w, 1, d_latent=128)
    toks = w["toks"][:40]
    ids, strength = S.latent_doc_sequences(tp, toks, top_k=top_k)
    jids, jstrength = JS.latent_doc_sequences(jp, toks, top_k=top_k)
    assert ids.dtype == np.int32 and ids.shape == (40, top_k)
    assert strength.dtype == np.float32
    np.testing.assert_allclose(strength, jstrength, **F32)
    gap = np.abs(np.diff(jstrength, axis=1))
    bar = F32["atol"] + F32["rtol"] * np.abs(jstrength)
    clear = np.ones_like(jstrength, bool)
    clear[:, 1:] &= gap > bar[:, 1:]
    clear[:, :-1] &= gap > bar[:, :-1]
    np.testing.assert_array_equal(ids[clear], jids[clear])
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(ids == -1, jids == -1)


def test_encode_docs_chunks_equal_one_pass(seine_world):
    w = seine_world
    _, tp = _params(w, 2)
    toks = w["toks"][:30]
    whole = S.encode(tp, torch.from_numpy(toks))
    for chunk in (7, 30, 64):
        np.testing.assert_allclose(_np(S.encode_docs(tp, toks, chunk)),
                                   _np(whole), **F32)


def test_latent_embeddings_match_jax(seine_world):
    jp, tp = _params(seine_world, 3)
    got = S.latent_embeddings(tp)
    np.testing.assert_allclose(_np(got), _np(JS.latent_embeddings(jp)),
                               **F32)
    np.testing.assert_allclose(torch.linalg.norm(got, dim=-1).numpy(), 1.0,
                               **F32)


def test_converter_checks_names_and_shapes(seine_world):
    jp, _ = _params(seine_world, 0)
    with pytest.raises(ValueError, match="SNRM parameters"):
        snrm_params_from_numpy({"emb": jp["emb"], "w1": jp["w1"]},
                               device="cpu")
    with pytest.raises(ValueError, match="chain"):
        snrm_params_from_numpy(dict(jp, w2=np.zeros((3, 4), np.float32)),
                               device="cpu")


def test_init_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.init_snrm(100, 8)
