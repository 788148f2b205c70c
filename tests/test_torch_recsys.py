"""PyTorch port of the recsys models (``models.recsys``), their configs
(``configs.recsys_archs``, the shape sets, ``get_bundle`` / ``smoke``),
their data (``data.recsys_data``) and their trainer
(``launch.train.train_recsys``), held against the JAX package on the
CPU.

Parameters cross from JAX through ``convert.recsys_params_from_numpy``;
inputs are drawn with numpy from a seed and fed to both packages.  Bars:
configs and data exact; forward and scores at rtol 1e-5 / atol 1e-6; the
loss and every gradient (against ``jax.value_and_grad``) at rtol 1e-4 /
atol 1e-5 (tests/test_kernels.py's float32 bar), BERT4Rec's through the
``flash_attn`` wrappers (their plain versions on the CPU); five trainer
steps held from the reference's own state (ROADMAP Queue 3 item 5): at
the reference's parameters the loss and every gradient, and the port's
clipping and Adam update of the reference's gradients and moments give
the reference's next parameters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro import train as jax_train
from repro.ckpt.checkpoint import _flatten_with_paths as jax_flatten
from repro.data import recsys_data as jax_data
from repro.models import recsys as JR
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.convert import recsys_params_from_numpy
from repro_torch.data import recsys_data
from repro_torch.kernels.flash_attn import flash_attention_plain
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.launch import train as train_cli
from repro_torch.models import recsys as R
from repro_torch.train import (adam, apply_updates, clip_by_global_norm,
                               value_and_grad)
import torch_threads  # noqa: F401  (PyTorch threads per test process)

ARCHS = ("autoint", "dlrm-mlperf", "sasrec", "bert4rec")
FWD = dict(rtol=1e-5, atol=1e-6)
F32 = dict(rtol=1e-4, atol=1e-5)
JAX_INIT = {"attn-ctr": JR.autoint_init, "dlrm": JR.dlrm_init,
            "seq-rec": JR.seqrec_init}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _params(arch, seed=1):
    """(reference config, port config, JAX params, port params)."""
    jc, c = jax_configs.smoke(arch), configs.smoke(arch)
    jp = JAX_INIT[jc.family](jc, jax.random.key(seed))
    return jc, c, jp, recsys_params_from_numpy(
        jax.tree.map(np.asarray, jp), c, device="cpu")


def _jax_loss(jc):
    if jc.family == "attn-ctr":
        return lambda p, b: JR.bce_loss(
            JR.autoint_forward(p, jc, b["sparse_ids"]), b["label"])
    if jc.family == "dlrm":
        return lambda p, b: JR.bce_loss(
            JR.dlrm_forward(p, jc, b["dense"], b["sparse_ids"]), b["label"])
    if jc.causal:
        return lambda p, b: JR.sasrec_loss(p, jc, b)
    return lambda p, b: JR.bert4rec_loss(p, jc, b)


def _grads_match(got, want, tol=F32):
    g, w = T.flatten_with_paths(got), jax_flatten(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (n, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol, err_msg=n)


def _counting(monkeypatch):
    """Count the calls of the flash_attn wrappers the autograd Function
    reaches (their plain versions on CPU tensors)."""
    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "flash_attn_kernel"),
                      ("bwd", "flash_attn_bwd_kernel")):
        fn = getattr(fa_ops, name)

        def wrapped(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(fa_ops, name, wrapped)
    return calls


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_matches_jax():
    """Every bundle (LM, GNN, recsys): the id list, each config and its
    shapes field by field, the domain, and ``smoke`` of every id."""
    assert configs.ALL_ARCH_IDS == jax_configs.ALL_ARCH_IDS
    assert list(configs.all_cells()) == list(jax_configs.all_cells())
    for aid in configs.ALL_ARCH_IDS:
        b, jb = configs.get_bundle(aid), jax_configs.get_bundle(aid)
        assert (b.arch_id, b.domain) == (jb.arch_id, jb.domain)
        assert dataclasses.asdict(b.config) == dataclasses.asdict(jb.config)
        assert [dataclasses.asdict(s) for s in b.shapes] == \
            [dataclasses.asdict(s) for s in jb.shapes]
        assert dataclasses.asdict(configs.smoke(aid)) == \
            dataclasses.asdict(jax_configs.smoke(aid))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_bundle("nope")


@pytest.mark.parametrize("arch", ARCHS)
def test_recsys_configs_match_jax(arch):
    c, jc = configs.get_bundle(arch).config, jax_configs.get_bundle(
        arch).config
    assert type(c).__name__ == type(jc).__name__ == "RecsysConfig"
    assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    assert dataclasses.asdict(configs.smoke(arch)) == \
        dataclasses.asdict(jax_configs.smoke(arch))


def test_shape_sets_match_jax():
    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"):
        got, want = getattr(configs, name), getattr(jax_configs, name)
        assert [dataclasses.asdict(s) for s in got] == \
            [dataclasses.asdict(s) for s in want], name
        assert [(s.is_train, s.is_decode) for s in got] == \
            [(s.is_train, s.is_decode) for s in want], name
    b = configs.get_bundle("bert4rec")
    assert b.shape("retrieval_cand").n_candidates == 1_000_000
    with pytest.raises(KeyError, match="has no shape"):
        b.shape("decode_32k")


def test_lm_config_getters_keep_working():
    for name in configs.LM_ARCH_IDS:
        assert configs.get_lm_config(name) is configs.get_bundle(name).config
    with pytest.raises(KeyError, match="unknown LM arch"):
        configs.get_lm_config("autoint")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_batches_are_the_references(arch, smoke):
    """``ctr_batch`` / ``seqrec_batch`` bitwise, smoke and published
    configs, three seeds."""
    get = (lambda m: m.smoke(arch)) if smoke else \
        (lambda m: m.get_bundle(arch).config)
    c, jc = get(configs), get(jax_configs)
    ctr = c.family in ("attn-ctr", "dlrm")
    for seed in (0, 7, 7919):
        if ctr:
            got = recsys_data.ctr_batch(c, 33, seed=seed)
            want = jax_data.ctr_batch(jc, 33, seed=seed)
        else:
            got = recsys_data.seqrec_batch(c, 9, seed=seed)
            want = jax_data.seqrec_batch(jc, 9, seed=seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_references_layout(arch):
    """The port's init draws the reference's tree (names, shapes, dtype)
    on the requested device; converted JAX parameters are the same
    tree."""
    jc, c, jp, tp = _params(arch)
    got = train_cli.recsys_init(c, torch.Generator().manual_seed(0), "cpu")
    names = [n for n, _ in jax_flatten(jp)]
    assert [n for n, _ in T.flatten_with_paths(got)] == names
    assert [n for n, _ in T.flatten_with_paths(tp)] == names
    for (n, a), (_, w) in zip(T.flatten_with_paths(got), jax_flatten(jp)):
        assert tuple(a.shape) == w.shape and a.dtype == torch.float32, n
    bad = jax.tree.map(np.asarray, jp)
    bad["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="layout"):
        recsys_params_from_numpy(bad, c, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_scores_match_jax(arch):
    """CTR logits, or a sequence model's pair scores and candidate scores,
    at rtol 1e-5 / atol 1e-6.  The encoder's hidden states, which leave
    three layer norms (each differs from the reference's by its
    summation order: 7e-7 from the same input), are held at the float32
    bar."""
    jc, c, jp, tp = _params(arch)
    rng = np.random.RandomState(3)
    if c.family in ("attn-ctr", "dlrm"):
        b = recsys_data.ctr_batch(c, 40, seed=3)
        if c.family == "dlrm":
            want = JR.dlrm_forward(jp, jc, jnp.asarray(b["dense"]),
                                   jnp.asarray(b["sparse_ids"]))
            got = R.dlrm_forward(tp, c, torch.from_numpy(b["dense"]),
                                 torch.from_numpy(b["sparse_ids"]))
        else:
            want = JR.autoint_forward(jp, jc, jnp.asarray(b["sparse_ids"]))
            got = R.autoint_forward(tp, c, torch.from_numpy(b["sparse_ids"]))
        np.testing.assert_allclose(_np(got), np.asarray(want), **FWD)
        return
    items = recsys_data.seqrec_batch(c, 6, seed=3)["items"]
    # targets and candidates past both ends of the table clip as jnp's
    target = rng.randint(-3, c.n_items + 600, 6)
    cand = np.concatenate([rng.randint(0, c.n_items, 50), [-1, 10 ** 6]])
    ji, ti = jnp.asarray(items), torch.from_numpy(items)
    h = R.seqrec_encode(tp, c, ti)
    jh = JR.seqrec_encode(jp, jc, ji)
    np.testing.assert_allclose(_np(h), np.asarray(jh), **F32)
    np.testing.assert_allclose(
        _np(R.seqrec_pair_scores(tp, c, ti, torch.from_numpy(target))),
        np.asarray(JR.seqrec_pair_scores(jp, jc, ji, jnp.asarray(target))),
        **FWD)
    np.testing.assert_allclose(
        _np(R.seqrec_score_items(tp, h[:, -1], torch.from_numpy(cand))),
        np.asarray(JR.seqrec_score_items(jp, jh[:, -1], jnp.asarray(cand))),
        **FWD)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, monkeypatch):
    """The training loss of each arch and every gradient at rtol 1e-4 /
    atol 1e-5.  BERT4Rec (head dim 32) runs the flash_attn wrappers,
    forward and backward, once per block; SASRec (head dim 50) never."""
    jc, c, jp, tp = _params(arch)
    calls = _counting(monkeypatch)
    nb = train_cli.recsys_batches(c, 2, "cpu", 48)
    batch = nb(0)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want_l, want_g = jax.jit(jax.value_and_grad(_jax_loss(jc)))(jp, jb)
    loss, grads = value_and_grad(train_cli.recsys_loss_fn(c), tp, batch)
    np.testing.assert_allclose(float(loss), float(want_l), **F32)
    _grads_match(grads, want_g)
    n = c.n_blocks if arch == "bert4rec" else 0
    assert calls == {"fwd": n, "bwd": n}
    assert R.uses_flash_attn(c) == (arch == "bert4rec")


def test_bert4rec_plain_attention_gives_the_kernels_step(deterministic):
    """The step a card run holds its kernels against: the same loss and
    gradients through ``flash_attention_plain`` (on the CPU both routes
    run the plain versions, so under torch's deterministic mode, where
    the table's gradient is no longer summed with atomics across
    threads, they agree bitwise)."""
    _, c, _, tp = _params("bert4rec")
    batch = train_cli.recsys_batches(c, 0, "cpu")(0)
    a = value_and_grad(train_cli.recsys_loss_fn(c), tp, batch)
    b = value_and_grad(train_cli.recsys_loss_fn(c, flash_attention_plain),
                       tp, batch)
    assert torch.equal(a[0], b[0])
    for x, y in zip(T.leaves(a[1]), T.leaves(b[1])):
        assert torch.equal(x, y)


def test_bert4rec_tail_shape_matches_jax():
    """BERT4Rec's published head layout (2 heads of 32, non-causal) at a
    sequence of 200, which is no multiple of the kernels' 64-row tiles:
    the encoder through the flash_attn wrappers and its gradients
    against the reference's one-chunk ``gqa_attention``."""
    jc = dataclasses.replace(jax_configs.get_bundle("bert4rec").config,
                             n_items=700, n_blocks=1)
    c = dataclasses.replace(configs.get_bundle("bert4rec").config,
                            n_items=700, n_blocks=1)
    jp = JR.seqrec_init(jc, jax.random.key(4))
    tp = recsys_params_from_numpy(jax.tree.map(np.asarray, jp), c, "cpu")
    batch = train_cli.recsys_batches(c, 1, "cpu", 3)(0)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want_l, want_g = jax.jit(jax.value_and_grad(_jax_loss(jc)))(jp, jb)
    loss, grads = value_and_grad(train_cli.recsys_loss_fn(c), tp, batch)
    np.testing.assert_allclose(float(loss), float(want_l), **F32)
    _grads_match(grads, want_g)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _jax_step(jloss, lr):
    """The reference's ``make_train_step`` (its ``clip_by_global_norm``
    at 1.0, ``adam(lr)``, ``apply_updates``) as one jitted function that
    also returns the gradients: (loss, grads, grad norm, next params,
    next moments)."""
    opt = jax_train.adam(lr)

    @jax.jit
    def step(p, o, b):
        loss, g = jax.value_and_grad(jloss)(p, b)
        clipped, norm = jax_train.clip_by_global_norm(g, 1.0)
        upd, o_next = opt.update(clipped, o, p)
        return loss, g, norm, jax_train.apply_updates(p, upd), o_next
    return opt, step


@pytest.mark.parametrize("arch", ARCHS)
def test_train_recsys_steps_match_jax(arch):
    """Five steps of the reference's ``train_recsys`` recipe held from its
    own state: its batches (``recsys_batches`` == its generator's), at
    its parameters the port's loss and every gradient, then the port's
    clipping and ``adam(1e-3)`` update of its gradients and moments give
    its next parameters.  (The loss history of whole runs from its
    weights is ``tests/test_torch_train.py``'s CLI case.)"""
    jc, c, jp, _ = _params(arch, seed=0)
    jopt, jstep = _jax_step(_jax_loss(jc), train_cli.RECSYS_LR)
    jo = jopt.init(jp)
    opt = adam(train_cli.RECSYS_LR)
    batches = train_cli.recsys_batches(c, 0, "cpu")
    gen = jax_data.ctr_batch if c.family in ("attn-ctr", "dlrm") \
        else jax_data.seqrec_batch
    n = train_cli.RECSYS_BATCH["ctr" if c.family in ("attn-ctr", "dlrm")
                               else "seq"]
    to_port = lambda tree: recsys_params_from_numpy(
        jax.tree.map(np.asarray, tree), c, device="cpu")
    for i in range(5):
        batch = batches(i)
        ref = gen(jc, n, seed=i)
        for k, v in ref.items():
            np.testing.assert_array_equal(batch[k].numpy(), v, err_msg=k)
        jl, jg, jnorm, jp_next, jo_next = jstep(
            jp, jo, {k: jnp.asarray(v) for k, v in ref.items()})
        at = to_port(jp)
        loss, g = value_and_grad(train_cli.recsys_loss_fn(c), at, batch)
        np.testing.assert_allclose(float(loss), float(jl), **F32)
        _grads_match(g, jg)
        clipped, norm = clip_by_global_norm(to_port(jg), 1.0)
        np.testing.assert_allclose(float(norm), float(jnorm), **F32)
        upd, _ = opt.update(clipped, _to_torch(jo), at)
        _grads_match(apply_updates(at, upd), jp_next)
        jp, jo = jp_next, jo_next


def test_train_recsys_draws_its_weights_from_the_seed():
    """``train_recsys`` on the CPU: the smoke config's init from a
    generator seeded by ``seed``, then the reference's batches."""
    c = configs.smoke("dlrm-mlperf")
    res = train_cli.train_recsys("dlrm-mlperf", 2, None, seed=3,
                                 device="cpu", verbose=False)
    init = train_cli.recsys_init(c, torch.Generator().manual_seed(3), "cpu")
    loss = train_cli.recsys_loss_fn(c)(
        init, train_cli.recsys_batches(c, 3, "cpu")(0))
    assert res.history[0]["loss"] == loss.item()
    assert res.state.step == 2
    with pytest.raises(KeyError, match="unknown arch"):
        train_cli.train_recsys("resnet", 1, None, device="cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device`` the inits and trainers ask for CUDA and raise
    when there is none; they never fall back to the CPU."""
    from repro_torch.models import mace as MA

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for arch in ARCHS:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.recsys_init(configs.smoke(arch), gen)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.train_recsys(arch, 1, None, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MA.init_params(configs.smoke("mace"), gen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.train_gnn(1, None, verbose=False)
