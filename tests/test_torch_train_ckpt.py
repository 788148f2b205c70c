"""The port's training checkpoints (``repro_torch.ckpt.save_checkpoint``
/ ``restore_checkpoint`` / ``latest_step`` / ``all_steps``) and the train
loop's resume (``repro_torch.train.fit``) against the JAX package's, on
the CPU.

A checkpoint written by either package is read by the other with the
same leaf names and the leaves bitwise.  ``fit`` resumes from the latest
checkpoint, its own or the reference's, to the uninterrupted run's
parameters at atol 1e-5 (the reference test's bar).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jax_ckpt
from repro import train as jax_train
from repro.ckpt.checkpoint import _flatten_with_paths as jax_flatten
from repro.dist import init_error_feedback as jax_init_ef
from repro.retrievers import get_retriever as jax_get
from repro_torch import tree as T
from repro_torch.ckpt import (all_steps, latest_step, restore_checkpoint,
                              save_checkpoint, wait_async)
from repro_torch.convert import params_from_jax
from repro_torch.dist.compression import init_error_feedback
from repro_torch.dist.fault import PreemptionGuard
from repro_torch import train
import torch_threads  # noqa: F401  (PyTorch threads per test process)

FUNCTIONS = ("tf", "idf_indicator", "dot", "cosine", "gauss_max",
             "linear_agg", "max_op", "mlp_emb", "log_cond_prob")


def _jax_state(rng, name="deeptilebars"):
    """A ranker's parameters and an adam state three updates in, JAX."""
    jp = jax_get(name).init(jax.random.key(0), 5, FUNCTIONS)
    opt = jax_train.adam(0.01)
    st = opt.init(jp)
    for _ in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.randn(*p.shape).astype(np.float32)), jp)
        upd, st = opt.update(g, st, jp)
        jp = jax_train.apply_updates(jp, upd)
    return {"params": jp, "opt": st, "residual": jax_init_ef(jp)}


def _port_state(jtree, name="deeptilebars"):
    """The same state in the port: a ParamTree and plain trees."""
    to = lambda x: torch.tensor(np.asarray(x))
    return {"params": params_from_jax(name, jtree["params"], device="cpu"),
            "opt": jax.tree.map(to, jtree["opt"]),
            "residual": jax.tree.map(to, jtree["residual"])}


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_port_checkpoint_is_read_by_jax(tmp_path):
    jtree = _jax_state(np.random.RandomState(0))
    ptree = _port_state(jtree)
    path = save_checkpoint(str(tmp_path / "p"), 7, ptree,
                           extra={"data": {"seed": 0, "step": 7}})
    assert path.endswith("ckpt_0000000007")
    names = [n for n, _ in jax_flatten(jtree)]
    assert _manifest(path)["names"] == names
    assert "params/convs/0/b" in names and "opt/step" in names
    target = jax.tree.map(jnp.zeros_like, jtree)
    got, manifest = jax_ckpt.restore_checkpoint(str(tmp_path / "p"), target)
    assert manifest["step"] == 7 and manifest["extra"]["data"]["step"] == 7
    for (n, a), (_, b) in zip(jax_flatten(got), T.flatten_with_paths(ptree)):
        assert np.asarray(a).dtype == b.detach().numpy().dtype, n
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy(),
                                      err_msg=n)
    assert np.asarray(got["opt"]["step"]).dtype == np.int32


def test_jax_checkpoint_is_read_by_the_port(tmp_path):
    jtree = _jax_state(np.random.RandomState(1))
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), 12, jtree, keep=2)
    # the port's target: other values, the same structure
    ptree = _port_state(_jax_state(np.random.RandomState(2)))
    w = ptree["params"]["mlp"]["w"][0]
    got, manifest = restore_checkpoint(str(tmp_path / "j"), ptree)
    assert manifest["step"] == 12
    assert manifest["names"] == [n for n, _ in T.flatten_with_paths(ptree)]
    for (n, a), (_, b) in zip(T.flatten_with_paths(got), jax_flatten(jtree)):
        assert a.numpy().dtype == np.asarray(b).dtype, n
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=n)
    assert isinstance(got["params"], dict)
    # assign() copies into the ParamTree in place
    params = T.assign(ptree["params"], got["params"])
    assert params is ptree["params"] and params["mlp"]["w"][0] is w
    np.testing.assert_array_equal(w.detach().numpy(),
                                  np.asarray(jtree["params"]["mlp"]["w"][0]))


def test_retention_extra_and_errors(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.arange(6.0).reshape(2, 3), "n": {"b": torch.ones(4)},
            "none": None}
    assert all_steps(d) == [] and latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, tree)
    for step in (10, 20, 30, 40):
        save_checkpoint(d, step, tree, keep=2, extra={"data": {"pos": step}})
    assert all_steps(d) == [30, 40] and latest_step(d) == 40
    assert jax_ckpt.all_steps(d) == [30, 40]
    got, manifest = restore_checkpoint(
        d, T.tree_map(torch.zeros_like, tree))
    assert manifest["extra"]["data"]["pos"] == 40
    assert manifest["names"] == ["n/b", "w"] and got["none"] is None
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"].numpy())
    got, manifest = restore_checkpoint(d, tree, step=30)
    assert manifest["step"] == 30
    with pytest.raises(ValueError, match="shape mismatch for w"):
        restore_checkpoint(d, {"w": torch.zeros(3), "n": {"b": torch.ones(4)}})
    with pytest.raises(KeyError, match="checkpoint missing leaf x"):
        restore_checkpoint(d, {"x": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match="not ported"):
        restore_checkpoint(d, tree, shardings={"w": None})


def test_async_save_copies_on_the_callers_thread(tmp_path):
    """The parameters change in place right after an async save; the
    checkpoint holds the values at the save."""
    jtree = _jax_state(np.random.RandomState(3))
    ptree = _port_state(jtree)
    before = {n: v.detach().clone() for n, v in T.flatten_with_paths(ptree)}
    save_checkpoint(str(tmp_path), 1, ptree, async_write=True)
    with torch.no_grad():
        for p in ptree["params"].parameters():
            p.add_(1.0)
    wait_async()
    got, _ = restore_checkpoint(str(tmp_path), ptree)
    for n, v in T.flatten_with_paths(got):
        assert torch.equal(v, before[n]), n


# ---------------------------------------------------------------------------
# fit: resume, preemption, the double save of the last step
# ---------------------------------------------------------------------------

def _batch_np(step):
    return (np.random.RandomState(step).randn(3) * 0.1
            + np.array([1.0, 2.0, 3.0])).astype(np.float32)


def _make_port():
    params = {"w": torch.zeros(3)}
    opt = train.adam(0.05)
    step_fn = train.make_train_step(
        lambda p, b: torch.sum((p["w"] - b) ** 2), opt)
    st = train.TrainState(params=params, opt_state=opt.init(params),
                          residual=init_error_feedback(params))
    return st, step_fn, lambda step: torch.from_numpy(_batch_np(step))


def _make_jax():
    params = {"w": jnp.zeros(3)}
    opt = jax_train.adam(0.05)
    step_fn = jax_train.make_train_step(
        lambda p, b: jnp.sum((p["w"] - b) ** 2), opt, donate=False)
    st = jax_train.TrainState(params=params, opt_state=opt.init(params),
                              residual=jax_init_ef(params))
    return st, step_fn, lambda step: jnp.asarray(_batch_np(step))


def test_fit_resume_after_preemption(tmp_path):
    """The reference's test in the port: 12 steps with checkpoints, then a
    fresh fit() resumes to 30, equal to the uninterrupted run."""
    ck = str(tmp_path / "ck")
    ref = train.fit(*_make_port(), n_steps=30, verbose=False)
    train.fit(*_make_port(), n_steps=12, ckpt_dir=ck, ckpt_every=6,
              verbose=False)
    assert latest_step(ck) == 12
    res = train.fit(*_make_port(), n_steps=30, ckpt_dir=ck, ckpt_every=100,
                    verbose=False)
    assert res.state.step == 30 and len(res.history) == 18
    np.testing.assert_allclose(res.state.params["w"].numpy(),
                               ref.state.params["w"].numpy(), atol=1e-5)
    assert res.state.opt_state["step"].dtype == torch.int32


def test_fit_checkpoints_and_stops_on_preemption(tmp_path):
    ck = str(tmp_path / "ck")
    guard = PreemptionGuard(install=False)
    st, step_fn, nb = _make_port()

    def next_batch(step):
        if step == 9:
            guard.request_stop()
        return nb(step)

    res = train.fit(st, step_fn, next_batch, n_steps=30, ckpt_dir=ck,
                    ckpt_every=100, guard=guard, verbose=False,
                    data_state=lambda: {"seed": 0, "step": st.step})
    assert res.state.step == 10 and latest_step(ck) == 10
    assert _manifest(os.path.join(ck, "ckpt_0000000010"))["extra"] == {
        "data": {"seed": 0, "step": 10}}
    ref = train.fit(*_make_port(), n_steps=30, verbose=False)
    res = train.fit(*_make_port(), n_steps=30, ckpt_dir=ck, verbose=False)
    np.testing.assert_allclose(res.state.params["w"].numpy(),
                               ref.state.params["w"].numpy(), atol=1e-5)


def test_port_resumes_a_jax_run(tmp_path):
    """JAX fit writes step 12; the port resumes to 30, equal to JAX's
    uninterrupted run (atol 1e-5)."""
    ck = str(tmp_path / "ck")
    ref = jax_train.fit(*_make_jax(), n_steps=30, verbose=False)
    # ckpt_every 5: one save of step 12 (the reference's fit saves a step
    # that ckpt_every divides twice, and its two writes share a temp dir)
    jax_train.fit(*_make_jax(), n_steps=12, ckpt_dir=ck, ckpt_every=5,
                  verbose=False)
    assert latest_step(ck) == 12 == jax_ckpt.latest_step(ck)
    res = train.fit(*_make_port(), n_steps=30, ckpt_dir=ck, verbose=False)
    assert res.state.step == 30 and len(res.history) == 18
    np.testing.assert_allclose(res.state.params["w"].numpy(),
                               np.asarray(ref.state.params["w"]), atol=1e-5)
    # and JAX resumes the port's step 30 as its own
    back, manifest = jax_ckpt.restore_checkpoint(
        ck, {"params": ref.state.params, "opt": ref.state.opt_state,
             "residual": ref.state.residual})
    assert manifest["step"] == 30
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]),
                                  res.state.params["w"].numpy())


def test_fit_saves_the_last_step_twice_without_a_race(tmp_path):
    """n_steps a multiple of ckpt_every: the last step is saved twice,
    both async; every write has its own temp dir, so neither publishes
    into the other (the reference's fit fails here)."""
    for i in range(20):
        ck = str(tmp_path / f"ck{i}")
        res = train.fit(*_make_port(), n_steps=6, ckpt_every=3, keep=2,
                        ckpt_dir=ck, verbose=False)
        assert res.state.step == 6
        assert sorted(os.listdir(ck)) == ["ckpt_0000000003",
                                          "ckpt_0000000006"], i
        got, manifest = restore_checkpoint(
            ck, {"params": res.state.params, "opt": res.state.opt_state,
                 "residual": res.state.residual})
        assert manifest["step"] == 6
        assert torch.equal(got["params"]["w"], res.state.params["w"])


def test_concurrent_saves_of_one_step_publish_one_checkpoint(tmp_path):
    """16 async saves of the same step at once (more writers than cores,
    a short switch interval): every one publishes, the last publish wins
    whole, and no temp or moved-aside directory is left."""
    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i in range(16):
            save_checkpoint(str(tmp_path), 5, {"w": torch.full((64,),
                                                             float(i))},
                            keep=2, async_write=True)
        wait_async()
    finally:
        sys.setswitchinterval(interval)
    assert os.listdir(tmp_path) == ["ckpt_0000000005"]
    got, manifest = restore_checkpoint(str(tmp_path), {"w": torch.zeros(64)})
    assert manifest["step"] == 5
    assert len(set(got["w"].tolist())) == 1          # one write, whole


def _bf16_lm_tree(seed):
    """A bf16 LM state as the reference's train_lm checkpoints it: bf16
    parameters (a float32 router), float32 AdamW moments and residual."""
    from repro.configs import smoke as jax_smoke
    from repro.models import transformer as JT
    import dataclasses
    cfg = dataclasses.replace(jax_smoke("granite-moe-3b-a800m"),
                              dtype="bfloat16")
    jp = JT.init_params(cfg, jax.random.key(seed))
    opt = jax_train.adamw(3e-4)
    return {"params": jp, "opt": opt.init(jp), "residual": jax_init_ef(jp)}


def _bits(x):
    """A leaf's raw bytes and numpy dtype string, bf16 read as its bits."""
    a = x.detach().cpu() if isinstance(x, torch.Tensor) else np.asarray(x)
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().tobytes()
    return a.tobytes()


def test_jax_bf16_checkpoint_restores_bitwise_in_the_port(tmp_path):
    """A bf16 tree written by ``repro.ckpt.save_checkpoint`` (its bf16
    leaves stored as numpy ``|V2``) restores into bf16 targets bit for
    bit; the float32 leaves as before."""
    jtree = _bf16_lm_tree(0)
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), 3, jtree)
    target = jax.tree.map(lambda x: torch.zeros(
        x.shape, dtype=torch.bfloat16 if x.dtype == jnp.bfloat16
        else torch.float32), jtree)
    got, _ = restore_checkpoint(str(tmp_path / "j"), target)
    n_bf16 = 0
    for (n, a), (_, b) in zip(T.flatten_with_paths(got), jax_flatten(jtree)):
        want_dt = torch.bfloat16 if b.dtype == jnp.bfloat16 else None
        if want_dt is not None:
            n_bf16 += 1
            assert a.dtype == torch.bfloat16, n
        assert _bits(a) == _bits(b), n
    assert n_bf16 > 0
    assert got["params"]["layers"]["router"].dtype == torch.float32


def test_port_writes_bf16_leaves_as_the_reference(tmp_path):
    """The port's ``arrays.npz`` holds each bf16 leaf as ``|V2`` with the
    reference's bytes, and every other leaf as the reference does."""
    jtree = _bf16_lm_tree(1)
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), 5, jtree)
    ptree = jax.tree.map(lambda x: torch.from_numpy(
        np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)
        if x.dtype == jnp.bfloat16 else torch.from_numpy(np.array(x)), jtree)
    save_checkpoint(str(tmp_path / "p"), 5, ptree)
    name = os.path.join("ckpt_0000000005", "arrays.npz")
    with np.load(str(tmp_path / "j" / name)) as want, \
            np.load(str(tmp_path / "p" / name)) as got:
        assert sorted(got.files) == sorted(want.files)
        kinds = set()
        for n in want.files:
            assert got[n].dtype == want[n].dtype, n
            assert got[n].tobytes() == want[n].tobytes(), n
            kinds.add(got[n].dtype.str)
    assert "|V2" in kinds and "<f4" in kinds


def test_port_bf16_round_trip_is_bitwise(tmp_path):
    """Port to port: bf16, float32 and int32 leaves come back bit for
    bit, on a ParamTree too."""
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(4, 7, generator=g).bfloat16(),
            "b": [torch.randn(3, generator=g), torch.arange(5,
                                                            dtype=torch.int32)],
            "step": torch.tensor(9, dtype=torch.int32)}
    save_checkpoint(str(tmp_path / "p"), 1, tree)
    target = jax.tree.map(torch.zeros_like, tree)
    got, _ = restore_checkpoint(str(tmp_path / "p"), target)
    for (n, a), (_, b) in zip(T.flatten_with_paths(got),
                              T.flatten_with_paths(tree)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b), n
