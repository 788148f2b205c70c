"""The port's training substrate against the JAX package's, on the CPU:
optimizers (``repro_torch.train.optimizer``), gradient compression
(``repro_torch.dist.compression``), the LETOR metrics
(``repro_torch.data.metrics``), ``make_train_step`` and the trainers of
``repro_torch.launch.train`` for every retriever with parameters, and
the training CLI.

Inputs are drawn with numpy from a seed and fed to both packages.  Bars:
optimizer states and parameters at rtol 1e-6 / atol 1e-7 over 30
updates; int8 codes, top-k indices and metrics exact; error feedback at
rtol 1e-6; one ranker training step at rtol 1e-5 / atol 1e-6 (loss,
grad norm, gradients, updated parameters), 20 steps at rtol 1e-4 / atol
1e-5 (loss history, final parameters).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.ckpt.checkpoint import _flatten_with_paths as jax_flatten
from repro.data import metrics as jax_metrics
from repro.data.batching import PairSampler as JaxPairSampler
from repro.dist import compression as jax_comp
from repro.launch import train as jax_train_cli
from repro.retrievers import get_retriever as jax_get
from repro.serving import make_qmeta as jax_qmeta
from repro import train as jax_train
from repro.train import loop as jax_loop
from repro_torch import obs
from repro_torch import tree as T
from repro_torch.convert import params_from_jax
from repro_torch.data import metrics
from repro_torch.data.batching import PairSampler
from repro_torch.dist import compression as comp
from repro_torch.kernels.knrm_pool import knrm_pool, knrm_pool_kernel
from repro_torch.launch import train as train_cli
from repro_torch.models.layers import ParamTree
from repro_torch.retrievers import all_retrievers, get_retriever
from repro_torch import train
from repro_torch.train import loop as torch_loop
from torch_helpers import export, fresh_registry
import torch_threads  # noqa: F401  (PyTorch threads per test process)

OPT_TOL = dict(rtol=1e-6, atol=1e-7)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
RUN_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_trees_close(got, want, tol, what=""):
    """Same leaf names, in the same order, and values within ``tol``."""
    g = T.flatten_with_paths(got)
    w = jax_flatten(want)
    assert [n for n, _ in g] == [n for n, _ in w], what
    for (n, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol,
                                   err_msg=f"{what} {n}")


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _tree_np(rng):
    """Nested dicts and lists, leaves of rank 0-2 (adafactor factors the
    rank-2 ones)."""
    return {"w": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(3).astype(np.float32),
            "n": {"v": [rng.randn(5).astype(np.float32),
                        rng.randn(2, 6).astype(np.float32)],
                  "s": np.float32(rng.randn())}}


def _jax_tree(t):
    return jax.tree.map(jnp.asarray, t)


def _torch_tree(t):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), t)


OPTS = [
    ("sgd", lambda m: m.sgd(0.1)),
    ("sgd_m", lambda m: m.sgd(0.05, momentum=0.9)),
    ("adam", lambda m: m.adam(0.1)),
    ("adamw", lambda m: m.adamw(0.1, weight_decay=0.001)),
    ("adafactor", lambda m: m.adafactor(0.3)),
    ("adam_schedule", lambda m: m.adam(m.warmup_cosine(0.1, 5, 30))),
    ("get_optimizer", lambda m: m.get_optimizer("adamw", 0.05,
                                                weight_decay=0.1)),
]


@pytest.mark.parametrize("name,make", OPTS, ids=[o[0] for o in OPTS])
def test_optimizer_matches_jax_over_30_updates(name, make):
    rng = np.random.RandomState(0)
    p0 = _tree_np(rng)
    grads = [_tree_np(rng) for _ in range(30)]
    jopt, topt = make(jax_train), make(train)
    jp, tp = _jax_tree(p0), _torch_tree(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    assert_trees_close(ts, js, OPT_TOL, f"{name} init")
    for i, g in enumerate(grads):
        ju, js = jopt.update(_jax_tree(g), js, jp)
        jp = jax_train.apply_updates(jp, ju)
        tu, ts = topt.update(_torch_tree(g), ts, tp)
        tp = train.apply_updates(tp, tu)
        assert_trees_close(tu, ju, OPT_TOL, f"{name} update {i}")
    assert_trees_close(ts, js, OPT_TOL, f"{name} state")
    assert_trees_close(tp, jp, OPT_TOL, f"{name} params")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 30
    if name == "sgd":
        assert ts["mom"] is None


def test_optimizer_updates_a_param_tree_in_place():
    """A ParamTree is updated in place (the tensor an engine holds)."""
    rng = np.random.RandomState(1)
    p0 = _tree_np(rng)
    g = _tree_np(rng)
    pt = ParamTree(_torch_tree(p0))
    w = pt["w"]
    opt = train.adam(0.1)
    upd, _ = opt.update(_torch_tree(g), opt.init(pt), pt)
    assert train.apply_updates(pt, upd) is pt and pt["w"] is w
    jopt = jax_train.adam(0.1)
    jp = _jax_tree(p0)
    ju, _ = jopt.update(_jax_tree(g), jopt.init(jp), jp)
    assert_trees_close(pt, jax_train.apply_updates(jp, ju), OPT_TOL)


def test_global_norm_clip_and_schedule_at_the_reference_points():
    tree = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = train.clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(10.0)
    _, n2 = train.clip_by_global_norm(clipped, 1e9)
    assert float(n2) == pytest.approx(1.0, rel=1e-4)
    jtree = {"a": jnp.full((4,), 3.0), "b": jnp.full((4,), 4.0)}
    jclipped, jnorm = jax_train.clip_by_global_norm(jtree, 1.0)
    assert float(norm) == float(jnorm)
    assert_trees_close(clipped, jclipped, dict(rtol=0, atol=0))
    fn, jfn = train.warmup_cosine(1.0, 10, 100), \
        jax_train.warmup_cosine(1.0, warmup=10, total=100)
    assert float(fn(torch.tensor(5))) == pytest.approx(0.5)
    assert float(fn(torch.tensor(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(fn(torch.tensor(100))) == pytest.approx(0.1, rel=1e-2)
    for s in (0, 1, 5, 9, 10, 11, 37, 99, 100, 150):
        assert float(fn(torch.tensor(s))) == float(jfn(jnp.asarray(s))), s
        assert float(fn(s)) == pytest.approx(float(jfn(s)), rel=1e-6), s
    g = {"x": torch.tensor([3.0, 4.0])}
    assert float(train.global_norm(g)) == 5.0


def _quad_problem():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3), "b": torch.zeros(())}

    def loss(p, batch=None):
        return torch.sum((p["w"] - target) ** 2) + p["b"] ** 2
    return params, loss


@pytest.mark.parametrize("name,make", OPTS[:5], ids=[o[0] for o in OPTS[:5]])
def test_optimizer_converges(name, make):
    """The reference's convergence test, with autograd's gradients."""
    opt = make(train)
    params, loss = _quad_problem()
    state = opt.init(params)
    for _ in range(200):
        _, g = train.value_and_grad(loss, params, None)
        upd, state = opt.update(g, state, params)
        params = train.apply_updates(params, upd)
    assert float(loss(params)) < 0.05, name


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_int8_codes_and_scale_exact():
    rng = np.random.RandomState(2)
    for x in (rng.randn(1000).astype(np.float32),
              (rng.randn(7, 9) * 1e-3).astype(np.float32),
              np.array([0.5, -0.5, 1.5, 2.5, -127.0, 127.0], np.float32),
              np.zeros(5, np.float32)):
        q, s = comp.quantize_int8(torch.from_numpy(x))
        jq, js = jax_comp.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(
            comp.dequantize_int8(q, s).numpy(),
            np.asarray(jax_comp.dequantize_int8(jq, js)))
        assert float((comp.dequantize_int8(q, s)
                      - torch.from_numpy(x)).abs().max()) <= float(s) * 0.51


def test_topk_indices_and_values_exact_with_ties():
    rng = np.random.RandomState(3)
    x = rng.randint(-4, 5, size=(6, 8)).astype(np.float32)   # many ties
    for k in (1, 5, 13, 48):
        idx, vals = comp.topk_sparsify(torch.from_numpy(x), k)
        jidx, jvals = jax_comp.topk_sparsify(jnp.asarray(x), k)
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
        np.testing.assert_array_equal(
            comp.topk_densify(idx, vals, x.shape).numpy(),
            np.asarray(jax_comp.topk_densify(jidx, jvals, x.shape)))


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_error_feedback_matches_jax_over_20_rounds(scheme):
    rng = np.random.RandomState(4)
    p0 = _tree_np(rng)
    r, jr = comp.init_error_feedback(_torch_tree(p0)), \
        jax_comp.init_error_feedback(_jax_tree(p0))
    assert_trees_close(r, jr, dict(rtol=0, atol=0))
    sent = T.tree_map(torch.zeros_like, r)
    true = T.tree_map(torch.zeros_like, r)
    for i in range(20):
        g = _tree_np(rng)
        t, r = comp.compress_with_feedback(_torch_tree(g), r, scheme=scheme,
                                           topk_frac=0.2)
        jt, jr = jax_comp.compress_with_feedback(_jax_tree(g), jr,
                                                 scheme=scheme,
                                                 topk_frac=0.2)
        assert_trees_close(t, jt, OPT_TOL, f"{scheme} sent {i}")
        assert_trees_close(r, jr, OPT_TOL, f"{scheme} residual {i}")
        sent = T.tree_map(torch.add, sent, t)
        true = T.tree_map(torch.add, true, _torch_tree(g))
    # error feedback: sent + residual == the true sum
    for a, b, c in zip(T.leaves(sent), T.leaves(r), T.leaves(true)):
        np.testing.assert_allclose((a + b).numpy(), c.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="unknown compression scheme"):
        comp.compress_with_feedback({"w": torch.ones(2)},
                                    {"w": torch.zeros(2)}, scheme="fp4")


# ---------------------------------------------------------------------------
# LETOR metrics
# ---------------------------------------------------------------------------

def test_metrics_equal_jax_on_scores_with_ties():
    rng = np.random.RandomState(5)
    per, jper = [], []
    for q in range(12):
        n = rng.randint(1, 40)
        scores = rng.randint(0, 6, size=n).astype(np.float32)   # ties
        rels = rng.randint(0, 3, size=n).astype(np.int8)
        if q == 0:
            rels[:] = 0                    # no relevant doc
        got = metrics.evaluate_ranking(scores, rels)
        want = jax_metrics.evaluate_ranking(scores, rels)
        assert got == want, q
        per.append(got)
        jper.append(want)
        for k in (1, 3, 10):
            assert metrics.precision_at_k(rels, k) == \
                jax_metrics.precision_at_k(rels, k)
            assert metrics.ndcg_at_k(rels, k) == jax_metrics.ndcg_at_k(rels,
                                                                       k)
            assert metrics.dcg_at_k(rels, k) == jax_metrics.dcg_at_k(rels, k)
        assert metrics.average_precision(rels) == \
            jax_metrics.average_precision(rels)
    assert metrics.mean_metrics(per) == jax_metrics.mean_metrics(jper)


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

TARGET = np.array([1.0, -2.0, 3.0], np.float32)


def _batches(accum, n=30):
    rng = np.random.RandomState(6)
    shape = (accum, 3) if accum > 1 else (3,)
    return [(rng.randn(*shape) * 0.5 + TARGET).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("accum,compression", [(1, None), (2, None),
                                               (1, "int8"), (2, "topk")])
def test_train_step_matches_jax(accum, compression):
    """The reference's quadratic problem through make_train_step: 30
    steps, clipping active (clip_norm 1.0), against JAX.  With
    compression the JAX step runs op by op (``jax.disable_jit``): under
    jit XLA fuses ``c - q * scale`` and rounds the residual differently
    from its own eager ops, and an ulp there moves an int8 code by one."""
    def jloss(p, batch):
        return jnp.sum((p["w"] - batch) ** 2) + p["b"] ** 2

    def tloss(p, batch):
        return torch.sum((p["w"] - batch) ** 2) + p["b"] ** 2

    p0 = {"w": np.zeros(3, np.float32), "b": np.float32(0.5)}
    jopt, topt = jax_train.adam(0.05), train.adam(0.05)
    jstep = jax_train.make_train_step(jloss, jopt, accum=accum,
                                      compression=compression, donate=False)
    tstep = train.make_train_step(tloss, topt, accum=accum,
                                  compression=compression)
    jp, tp = _jax_tree(p0), _torch_tree(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    jr = jax_comp.init_error_feedback(jp)
    tr = comp.init_error_feedback(tp)
    for b in _batches(accum):
        with jax.disable_jit(compression is not None):
            jp, js, jr, jm = jstep(jp, js, jr, jnp.asarray(b))
        tp, ts, tr, tm = tstep(tp, ts, tr, torch.from_numpy(b))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       **STEP_TOL, err_msg=k)
    assert_trees_close(tp, jp, STEP_TOL, "params")
    assert_trees_close(ts, js, STEP_TOL, "opt")
    assert_trees_close(tr, jr, STEP_TOL, "residual")


# ---------------------------------------------------------------------------
# ranker training on the seine_world index
# ---------------------------------------------------------------------------

def _trainable():
    names = []
    for n in all_retrievers():
        if jax_get(n).init(jax.random.key(0), 2, ("tf",) * 9):
            names.append(n)
    return names


TRAINABLE = _trainable()


@pytest.fixture(scope="module")
def world(seine_world, tmp_path_factory):
    index = export(seine_world["index"], tmp_path_factory.mktemp("w") / "i")
    return dict(seine_world, port_index=index)


def _jax_loss_fn(spec, index):
    """The reference trainer's loss (``repro.launch.train``), on the
    given index."""
    def loss_fn(params, batch):
        def one(qi, p, n):
            sp = spec.score(params, index.qd_matrix(qi, p[None], impl="jnp"),
                            jax_qmeta(index, qi, p[None]), index.functions)
            sn = spec.score(params, index.qd_matrix(qi, n[None], impl="jnp"),
                            jax_qmeta(index, qi, n[None]), index.functions)
            return jnp.maximum(0.0, 1.0 - sp + sn).mean()
        return jax.vmap(one)(batch["q"], batch["pos"], batch["neg"]).mean()
    return loss_fn


def _jax_batches(world, seed=0):
    sampler = JaxPairSampler(world["ds"].qrels,
                             np.arange(len(world["queries"])),
                             batch_size=16, seed=seed)

    def nb(step):
        b = sampler.next_batch()
        return {"q": jnp.asarray(world["queries"][b["query"]]),
                "pos": jnp.asarray(b["pos"]), "neg": jnp.asarray(b["neg"])}
    return nb


def _init(name, world, seed=0):
    jp = jax_get(name).init(jax.random.key(seed), world["index"].n_b,
                            world["index"].functions)
    return jp, params_from_jax(name, jp, device="cpu")


def test_trainable_retrievers():
    assert TRAINABLE == ["deepimpact", "deeptilebars", "epic", "hint",
                         "knrm"]
    assert not train_cli.has_params(get_retriever("bm25").init(
        torch.Generator(), 5, (), device="cpu"))


@pytest.mark.parametrize("name", TRAINABLE)
def test_one_training_step_matches_jax(name, world):
    jindex, tindex = world["index"], world["port_index"]
    jp, tp = _init(name, world)
    sampler = PairSampler(world["ds"].qrels,
                          np.arange(len(world["queries"])), batch_size=16)
    batch = train_cli.pair_batches(sampler, world["queries"], "cpu")(0)
    jbatch = _jax_batches(world)(0)
    np.testing.assert_array_equal(batch["q"].numpy(), np.asarray(jbatch["q"]))
    jloss_fn = _jax_loss_fn(jax_get(name), jindex)
    tloss_fn = train_cli.ranker_loss_fn(name, tindex)
    jl, jg = jax.value_and_grad(jloss_fn)(jp, jbatch)
    tl, tg = train.value_and_grad(tloss_fn, tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), **STEP_TOL)
    assert_trees_close(tg, jg, STEP_TOL, f"{name} grads")
    jopt, topt = jax_train.adam(3e-3), train.adam(3e-3)
    jstep = jax_train.make_train_step(jloss_fn, jopt, donate=False)
    tstep = train.make_train_step(tloss_fn, topt)
    jp2, _, _, jm = jstep(jp, jopt.init(jp), jax_comp.init_error_feedback(jp),
                          jbatch)
    tp2, _, _, tm = tstep(tp, topt.init(tp), comp.init_error_feedback(tp),
                          batch)
    assert tp2 is tp                    # updated in place
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **STEP_TOL,
                                   err_msg=k)
    assert_trees_close(tp, jp2, STEP_TOL, f"{name} params")


def _jax_fit(name, world, jp, *, eager):
    jopt = jax_train.adam(3e-3)
    jstep = jax_train.make_train_step(
        _jax_loss_fn(jax_get(name), world["index"]), jopt, donate=False)
    st = jax_train.TrainState(params=jp, opt_state=jopt.init(jp),
                              residual=jax_comp.init_error_feedback(jp))
    with jax.disable_jit(eager):
        return jax_train.fit(st, jstep, _jax_batches(world), n_steps=20,
                             verbose=False)


# Retrievers held against the reference's op-by-op run, not its jitted
# one.  HiNT trains on pairs whose two docs match nothing: there the
# gradient is zero in exact arithmetic, and what is left is rounding noise
# of the gate's softmax over the docs' live segments, which Adam (eps
# 1e-8) turns into steps of ~lr * noise / eps.  XLA's fused gradient
# leaves other noise than the reference's own ops, so the reference's
# jitted and op-by-op runs differ past the bar; the port mirrors the ops
# (``models.layers.softmax``).
OP_BY_OP = {"hint"}


@pytest.mark.parametrize("name", TRAINABLE)
def test_20_training_steps_match_jax(name, world):
    """20 steps against the reference's trainer on the same batches:
    loss and grad-norm histories and every final parameter at rtol 1e-4
    / atol 1e-5; the reference run op by op for ``OP_BY_OP``, else
    jitted."""
    jp, tp = _init(name, world, seed=1)
    want = _jax_fit(name, world, jp, eager=name in OP_BY_OP)
    got = train_cli.train_ranker(name, world["port_index"],
                                 world["queries"], world["ds"].qrels, tp, 20,
                                 None, verbose=False)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in got.history],
                                   [h[k] for h in want.history], **RUN_TOL,
                                   err_msg=k)
    assert got.state.params is tp and got.state.step == 20
    assert_trees_close(tp, want.state.params, RUN_TOL, f"{name} params")


def test_knrm_pool_refuses_a_gradient_only_on_cuda():
    """On the CPU the plain version carries the gradient; the message's
    path runs on a CUDA tensor, simulated by the device check."""
    x = torch.rand(2, 3, 4, requires_grad=True)
    mask = torch.ones(2, 4)
    knrm_pool(x, mask).sum().backward()          # CPU: differentiable
    assert x.grad is not None

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    fake = x.detach().as_subclass(FakeCuda).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        knrm_pool_kernel(fake, mask)


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

def _main(mod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    mod.main()
    err = capsys.readouterr().err
    done = [ln for ln in err.splitlines()
            if ln.startswith("[repro.launch.train] done")]
    assert len(done) == 1, err
    return dict(w.split("=", 1) for w in done[0].split()[2:])


class _StepClock:
    """Stands in for the ``time`` module of a training loop, which reads
    ``perf_counter`` at the start and at the end of each step: every step
    takes 1 s, and step ``slow_step`` (counted from 0) ``slow`` s.  The
    straggler monitor flags a step that takes more than twice the median
    of the steps before it, so under wall time a slow last step (a loaded
    machine) flags it in one CLI and not in the other."""

    def __init__(self, slow_step=None, slow=10.0):
        self.slow_step, self.slow = slow_step, slow
        self.calls, self.now = 0, 0.0

    def perf_counter(self) -> float:
        if self.calls % 2:                      # the end of a step
            self.now += (self.slow if self.calls // 2 == self.slow_step
                         else 1.0)
        self.calls += 1
        return self.now


def _fake_clocks(monkeypatch, slow_step=None):
    """Each loop its own clock, both with the same steps."""
    for loop in (jax_loop, torch_loop):
        monkeypatch.setattr(loop, "time", _StepClock(slow_step))


def _cli_runs(tmp_path, monkeypatch, capsys):
    argv = ["--workload", "seine-ranker", "--retriever", "knrm", "--steps",
            "6"]
    want = _main(jax_train_cli, argv + ["--ckpt-dir", str(tmp_path / "j")],
                 monkeypatch, capsys)
    got = _main(train_cli, argv + ["--ckpt-dir", str(tmp_path / "t"),
                                   "--device", "cpu"], monkeypatch, capsys)
    return got, want


def test_cli_matches_jax(tmp_path, monkeypatch, capsys):
    fresh_registry(monkeypatch, jax_obs, obs)
    _fake_clocks(monkeypatch)
    got, want = _cli_runs(tmp_path, monkeypatch, capsys)
    assert got["steps"] == want["steps"] == "6"
    assert got["stragglers"] == "0"
    fams = set(obs.snapshot()["metrics"])
    assert fams == set(jax_obs.snapshot()["metrics"])
    assert {n for n in fams if n.startswith(("seine_train", "seine_ckpt"))} \
        == {"seine_train_steps_total", "seine_train_loss",
                             "seine_train_step_seconds",
                             "seine_ckpt_saves_total"}
    assert set(obs.span_stats()) >= {"train.step", "ckpt.save"}
    assert obs.REGISTRY.get("seine_train_steps_total").get() == 6
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir()) == \
        ["ckpt_0000000006"]


def test_cli_flags_the_same_straggler_as_jax(tmp_path, monkeypatch, capsys):
    """Both CLIs on clocks whose last step is 10x slower than the five
    before it: each flags that step, and both snapshots hold the same
    families, the straggler counter among them."""
    fresh_registry(monkeypatch, jax_obs, obs)
    _fake_clocks(monkeypatch, slow_step=5)
    got, want = _cli_runs(tmp_path, monkeypatch, capsys)
    assert got["steps"] == want["steps"] == "6"
    assert got["stragglers"] == want["stragglers"] == "1"
    fams = set(obs.snapshot()["metrics"])
    assert fams == set(jax_obs.snapshot()["metrics"])
    assert "seine_straggler_flagged_total" in fams
    assert obs.REGISTRY.get("seine_straggler_flagged_total").get() == \
        jax_obs.REGISTRY.get("seine_straggler_flagged_total").get() == 1


CLI_WORKLOADS = [["--workload", "recsys", "--arch", a]
                 for a in ("autoint", "dlrm-mlperf", "sasrec", "bert4rec")]
CLI_WORKLOADS += [["--workload", "gnn"]]


def _jax_weights(monkeypatch, argv):
    """The port's trainer starts from the reference's weights: its init
    (``jax.random.key(0)``) carried across by ``convert``."""
    from repro import configs as jax_configs
    from repro.models import mace as JM
    from repro.models import recsys as JR
    from repro_torch.convert import (mace_params_from_numpy,
                                     recsys_params_from_numpy)
    from repro_torch.models import mace as MA

    if argv[1] == "gnn":
        jp = JM.init_params(jax_configs.smoke("mace"), jax.random.key(0))
        monkeypatch.setattr(MA, "init_params", lambda c, gen, dev: (
            mace_params_from_numpy(jax.tree.map(np.asarray, jp), c, dev)))
        return
    jc = jax_configs.smoke(argv[3])
    init = {"attn-ctr": JR.autoint_init, "dlrm": JR.dlrm_init}.get(
        jc.family, JR.seqrec_init)
    jp = init(jc, jax.random.key(0))
    monkeypatch.setattr(train_cli, "recsys_init", lambda c, gen, dev: (
        recsys_params_from_numpy(jax.tree.map(np.asarray, jp), c, dev)))


def _recording_fits(monkeypatch):
    """Each package's ``fit``, wrapped to keep its result."""
    runs = {}
    for name, mod in (("jax", jax_train), ("port", train)):
        def rec(*a, _fit=mod.fit, _name=name, **k):
            runs[_name] = _fit(*a, **k)
            return runs[_name]
        monkeypatch.setattr(mod, "fit", rec)
    return runs


@pytest.mark.parametrize("argv", CLI_WORKLOADS,
                         ids=[a[-1] for a in CLI_WORKLOADS])
def test_cli_matches_jax_for_recsys_and_gnn(argv, tmp_path, monkeypatch,
                                            capsys):
    """``--workload recsys --arch A`` and ``--workload gnn``, 4 steps with
    a checkpoint directory: from the reference's weights the port's CLI
    gives ``repro.launch.train.main``'s loss history (rtol 1e-4 / atol
    1e-5), the same steps and the same checkpoint."""
    fresh_registry(monkeypatch, jax_obs, obs)
    _fake_clocks(monkeypatch)
    _jax_weights(monkeypatch, argv)
    runs = _recording_fits(monkeypatch)
    argv = argv + ["--steps", "4"]
    want = _main(jax_train_cli, argv + ["--ckpt-dir", str(tmp_path / "j")],
                 monkeypatch, capsys)
    got = _main(train_cli, argv + ["--ckpt-dir", str(tmp_path / "t"),
                                   "--device", "cpu"], monkeypatch, capsys)
    assert got["steps"] == want["steps"] == "4"
    np.testing.assert_allclose([h["loss"] for h in runs["port"].history],
                               [h["loss"] for h in runs["jax"].history],
                               **RUN_TOL)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir()) == \
        ["ckpt_0000000004"]


@pytest.mark.parametrize("argv", [CLI_WORKLOADS[3], CLI_WORKLOADS[4]],
                         ids=["bert4rec", "gnn"])
def test_cli_resumes_recsys_and_gnn_bitwise(argv, tmp_path, monkeypatch,
                                            capsys):
    """1 step into a checkpoint directory, then the CLI asked for 3
    resumes there and takes steps 2 and 3: their losses and gradient
    norms have the bits of an uninterrupted 3-step run's.  Under torch's
    deterministic mode: the CPU otherwise sums a gather's gradient with
    atomics across threads (on the card the scatter sorts its ids)."""
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for steps, where in (("1", "a"), ("3", "a"), ("3", "b")):
            monkeypatch.setattr(sys, "argv", ["train"] + argv + [
                "--steps", steps, "--device", "cpu", "--ckpt-dir",
                str(tmp_path / where)])
            runs.append(train_cli.main())
            assert "[repro.launch.train] done" in capsys.readouterr().err
    finally:
        torch.use_deterministic_algorithms(False)
    first, resumed, whole = (r.history for r in runs)
    assert len(first) == 1 and [h["step"] for h in resumed] == [2, 3]
    for key in ("loss", "grad_norm"):
        assert [h[key] for h in resumed] == [h[key] for h in whole[1:]]
    assert runs[1].state.step == runs[2].state.step == 3
    for a, b in zip(T.leaves(runs[1].state.params),
                    T.leaves(runs[2].state.params)):
        assert torch.equal(a, b)


def test_cli_argument_errors_match_jax(monkeypatch, capsys):
    msgs = []
    for mod, extra in ((jax_train_cli, []), (train_cli, ["--device",
                                                         "cpu"])):
        monkeypatch.setattr(sys, "argv", ["train", "--workload",
                                          "seine-ranker", "--retriever",
                                          "bm25"] + extra)
        with pytest.raises(SystemExit) as exc:
            mod.main()
        msgs.append(exc.value.code)
        monkeypatch.setattr(sys, "argv", ["train", "--workload", "nope"]
                            + extra)
        with pytest.raises(SystemExit) as exc:
            mod.main()
        assert exc.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[0] == msgs[2] == "bm25 has no trainable params"
    assert msgs[1] == msgs[3]
    # the trainer runs on the card by default and never on the CPU alone
    monkeypatch.setattr(sys, "argv", ["train", "--workload", "seine-ranker"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main()
