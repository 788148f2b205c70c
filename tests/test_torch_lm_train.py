"""LM training in the port (``models.transformer``'s ``chunked_ce_loss``,
``lm_loss`` and ``forward``'s per-layer remat; ``launch.train``'s
``lm_batches``, ``fit_lm``, ``train_lm`` and ``--workload lm``) held
against the JAX package on the CPU.

Weights cross from JAX through ``convert.lm_params_from_numpy``; tokens
and hidden states are drawn with numpy.  On the CPU attention's forward
and backward run the kernels' plain versions through the autograd
Function, so the gradients below come from the backward kernel's
algorithm, not from autograd of the forward.  Bar: rtol 1e-4 / atol
1e-5 (tests/test_kernels.py's float32 bar).
"""
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke as jax_smoke
from repro.launch import train as jax_train_cli
from repro.models import transformer as JT
from repro_torch import tree as TT
from repro_torch.configs import LM_ARCH_IDS, smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attn import (flash_attn_bwd_kernel,
                                            flash_attn_kernel)
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.train import value_and_grad
import torch_threads  # noqa: F401  (PyTorch threads per test process)

F32 = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _params(name, seed=0):
    """(jax config, port config, JAX params, the port's copy)."""
    jc, c = jax_smoke(name), smoke(name)
    jp = JT.init_params(jc, jax.random.key(seed))
    return jc, c, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), c,
                                           device="cpu")


def _batch(vocab, seed, n_b=3, n_s=40):
    """Next-token batch with some labels -1 (ignored)."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, vocab, (n_b, n_s + 1))
    labels = t[:, 1:].copy()
    labels[rng.rand(n_b, n_s) < 0.2] = -1
    return {"tokens": t[:, :-1].astype(np.int32),
            "labels": labels.astype(np.int32)}


def _grads_match(tg, jg):
    """Every leaf of the JAX gradient tree against the port's."""
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(TT.leaves(tg))
    for path, want in flat:
        got = tg
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(_np(got), _np(want), **F32,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("n_chunks", [1, 3, 7, 64])
def test_chunked_ce_loss_matches_jax(n_chunks):
    """Loss and gradients of ``chunked_ce_loss``: -1 labels, chunk counts
    that do not divide S = 40 (3 -> 2, 7 -> 5) and one past it."""
    rng = np.random.RandomState(n_chunks)
    hidden = rng.randn(3, 40, 32).astype(np.float32)
    unembed = (rng.randn(32, 300) / 4).astype(np.float32)
    labels = _batch(300, n_chunks, n_s=40)["labels"]
    labels[0] = -1                          # a row with nothing to count
    lab = jnp.asarray(labels)
    want, (wh, wu) = jax.value_and_grad(
        lambda h, u: JT.chunked_ce_loss(h, lab, u, n_chunks=n_chunks),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(unembed))
    h = torch.from_numpy(hidden).requires_grad_()
    u = torch.from_numpy(unembed).requires_grad_()
    got = T.chunked_ce_loss(h, torch.from_numpy(labels), u,
                            n_chunks=n_chunks)
    gh, gu = torch.autograd.grad(got, (h, u))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(gh), _np(wh), **F32)
    np.testing.assert_allclose(_np(gu), _np(wu), **F32)


def test_chunked_ce_loss_in_bf16_sums_in_float32():
    """bf16 hidden states and unembedding: float32 logits of the bf16
    operands, as the reference's ``preferred_element_type``; gradients
    in bf16.  All ignored: the loss is 0 over max(count, 1)."""
    rng = np.random.RandomState(0)
    hidden = jnp.asarray(rng.randn(2, 24, 32), jnp.bfloat16)
    unembed = jnp.asarray(rng.randn(32, 100) / 4, jnp.bfloat16)
    labels = _batch(100, 1, n_b=2, n_s=24)["labels"]
    want = JT.chunked_ce_loss(hidden, jnp.asarray(labels), unembed,
                              n_chunks=4)
    h = torch.from_numpy(np.asarray(hidden, np.float32)).bfloat16()
    u = torch.from_numpy(np.asarray(unembed, np.float32)).bfloat16()
    h.requires_grad_()
    got = T.chunked_ce_loss(h, torch.from_numpy(labels), u, n_chunks=4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    (gh,) = torch.autograd.grad(got, (h,))
    assert gh.dtype == torch.bfloat16
    none = T.chunked_ce_loss(h, torch.full((2, 24), -1), u)
    assert none.item() == 0.0


@pytest.mark.parametrize("name", LM_ARCH_IDS)
def test_lm_loss_and_gradients_match_jax(name):
    """``lm_loss`` and the gradient of every parameter (the MoE router's,
    expert and shared-expert weights, through the aux loss) against
    ``jax.value_and_grad`` of the reference's, 3 CE chunks."""
    jc, c, jp, tp = _params(name)
    batch = _batch(c.vocab_size, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jg = jax.jit(jax.value_and_grad(lambda p: JT.lm_loss(
        p, jb, jc, attn_chunk=16, ce_chunks=3)))(jp)
    got, tg = value_and_grad(lambda p, b: T.lm_loss(p, b, c, ce_chunks=3),
                             tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    _grads_match(tg, jg)


@pytest.mark.parametrize("name", ["stablelm-1.6b", "granite-moe-3b-a800m"])
def test_remat_is_bitwise(name):
    """Remat recomputes each layer in the backward: the same loss and
    gradients bit for bit as keeping its activations.  Each layer's
    weights are views of one ``unbind`` per stacked leaf, whose gradient
    is the stack of the layers'."""
    _, c, _, tp = _params(name)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(c.vocab_size, 2).items()}
    runs = [value_and_grad(lambda p, b, r=r: T.lm_loss(p, b, c, remat=r),
                           tp, batch) for r in (True, False)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(TT.leaves(runs[0][1]), TT.leaves(runs[1][1])):
        assert torch.equal(a, b)
    per_layer = [value_and_grad(lambda p, b: T.lm_loss(
        {**tp, "layers": {n: torch.stack([p[n][i] for i in range(
            c.n_layers)]) for n in p}}, b, c),
        {n: [t[i] for i in range(c.n_layers)]
         for n, t in tp["layers"].items()}, batch)]
    for n, g in runs[0][1]["layers"].items():
        np.testing.assert_allclose(
            _np(g), _np(torch.stack(per_layer[0][1][n])), **F32)


def test_remat_runs_only_under_autograd(monkeypatch):
    """Inference (no gradient) and ``kv_out`` skip the checkpoint and
    give the same hidden states."""
    calls = []
    monkeypatch.setattr(T, "checkpoint", lambda fn, *a, **k: calls.append(
        1) or fn(*a, **{n: v for n, v in k.items()
                        if n not in ("use_reentrant",
                                     "preserve_rng_state")}))
    _, c, _, tp = _params("stablelm-1.6b")
    tokens = torch.from_numpy(_batch(c.vocab_size, 3)["tokens"])
    with torch.no_grad():
        plain, _ = T.forward(tp, tokens, c)
    assert not calls
    kv = []
    with_kv, _ = T.forward(tp, tokens, c, kv_out=kv)
    assert not calls and len(kv) == c.n_layers
    live = {**tp, "layers": {n: t.clone().requires_grad_()
                             for n, t in tp["layers"].items()}}
    graded, _ = T.forward(live, tokens, c)
    assert len(calls) == c.n_layers
    assert torch.equal(plain, with_kv) and torch.equal(plain,
                                                       graded.detach())


def test_lm_batches_are_the_references():
    """The reference's tokens, step by step, and the same batch for a
    step asked out of order (a resumed run)."""
    rng = np.random.RandomState(3)
    want = [rng.randint(0, 512, (8, 65)) for _ in range(4)]
    nb = train_cli.lm_batches(512, 8, 64, 3, "cpu")
    for step in (0, 1, 2):
        b = nb(step)
        assert b["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(b["tokens"].numpy(), want[step][:, :-1])
        np.testing.assert_array_equal(b["labels"].numpy(), want[step][:, 1:])
    resumed = train_cli.lm_batches(512, 8, 64, 3, "cpu")
    np.testing.assert_array_equal(resumed(3)["tokens"].numpy(),
                                  want[3][:, :-1])
    np.testing.assert_array_equal(nb(1)["labels"].numpy(), want[1][:, 1:])


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("name", ["stablelm-1.6b", "granite-moe-3b-a800m"])
def test_train_lm_smoke_steps_match_jax(name):
    """Five steps of the reference's ``train_lm`` smoke run (its own
    weights from ``jax.random.key(0)``, its batches, ``adamw(3e-4)``,
    clipping at 1.0) against ``fit_lm`` from the same weights: the loss
    and gradient norm of every step.  Each step is also held from the
    reference's state: at its parameters the port's loss and every
    gradient equal the reference's, and the port's clipping and AdamW
    update of the reference's gradients and moments give the reference's
    next parameters (float32 bar).  The two runs' own parameters are not
    held to each other: a gradient that is ~0 in exact arithmetic (a
    granite-moe embedding row) carries float32 rounding noise of any
    summation order, and Adam scales it to a step of up to lr, so one
    such entry parts by 1.4e-5 after one step (ROADMAP Queue 3 item 5)."""
    from repro import train as jax_train
    from repro_torch.train import adamw, apply_updates, clip_by_global_norm

    want = jax_train_cli.train_lm(name, 5, None, smoke=True, verbose=False)
    jc, c, jp, tp = _params(name)
    got = train_cli.fit_lm(c, tp, train_cli.LM_BATCH[True], 5, None,
                           verbose=False)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in got.history],
                                   [h[key] for h in want.history], **F32,
                                   err_msg=key)
    n_b, n_s = train_cli.LM_BATCH[True]
    jloss = lambda p, b: JT.lm_loss(p, b, jc, attn_chunk=min(n_s, 512),
                                    ce_chunks=4)
    jstep = jax_train.make_train_step(jloss, jax_train.adamw(3e-4),
                                      donate=False)
    jgrad = jax.jit(jax.value_and_grad(jloss))
    jo = jax_train.adamw(3e-4).init(jp)
    jr = jax.tree.map(lambda p: jnp.zeros_like(p, jnp.float32), jp)
    opt = adamw(3e-4)
    batches = train_cli.lm_batches(c.vocab_size, n_b, n_s, 0, "cpu")
    to_port = lambda tree: lm_params_from_numpy(
        jax.tree.map(np.asarray, tree), c, device="cpu")
    for i in range(5):
        batch = batches(i)
        jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        jl, jg = jgrad(jp, jb)
        jp_next, jo_next, jr, jm = jstep(jp, jo, jr, jb)
        at = to_port(jp)
        loss, g = value_and_grad(train_cli.lm_loss_fn(c), at, batch)
        np.testing.assert_allclose(float(loss), float(jl), **F32)
        _grads_match(g, jg)
        clipped, norm = clip_by_global_norm(to_port(jg), 1.0)
        np.testing.assert_allclose(float(norm), float(jm["grad_norm"]),
                                   **F32)
        upd, _ = opt.update(clipped, _to_torch(jo), at)
        _grads_match(apply_updates(at, upd), jp_next)
        jp, jo = jp_next, jo_next


def test_train_lm_draws_its_weights_from_the_seed():
    """``train_lm`` on the CPU: ``init_params`` with a generator seeded by
    ``seed``, the smoke config at (8, 64); the first loss near ln V."""
    c = smoke("stablelm-1.6b")
    res = train_cli.train_lm("stablelm-1.6b", 2, None, device="cpu",
                             seed=4, verbose=False)
    init = T.init_params(c, torch.Generator().manual_seed(4), device="cpu")
    loss = T.lm_loss(init, train_cli.lm_batches(c.vocab_size, 8, 64, 4,
                                                "cpu")(0), c, ce_chunks=4)
    assert res.history[0]["loss"] == loss.item()
    assert abs(loss.item() - math.log(c.vocab_size)) < 1.0
    assert res.state.step == 2


def test_cli_trains_the_lm_on_the_cpu(monkeypatch, capsys):
    """``--workload lm --device cpu --steps 3``: the smoke config, a
    finite loss in the log, no kernel launch on the CPU."""
    monkeypatch.setattr(sys, "argv", ["train", "--workload", "lm",
                                      "--device", "cpu", "--steps", "3"])
    before = (flash_attn_kernel.launches, flash_attn_bwd_kernel.launches)
    train_cli.main()
    err = capsys.readouterr().err
    done = [ln for ln in err.splitlines()
            if ln.startswith("[repro.launch.train] done")]
    assert len(done) == 1, err
    fields = dict(w.split("=", 1) for w in done[0].split()[2:])
    assert fields["steps"] == "3"
    first, last = (float(x) for x in fields["loss"].split("->"))
    assert np.isfinite(first) and np.isfinite(last)
    assert (flash_attn_kernel.launches,
            flash_attn_bwd_kernel.launches) == before
