"""PyTorch port of MACE (``models.mace``), its config
(``configs.gnn_archs``), its graph data (``data.graph``) and its trainer
(``launch.train.train_gnn``), held against the JAX package on the CPU.

Parameters cross from JAX through ``convert.mace_params_from_numpy``;
graphs come from the port's ``batched_molecules`` (bitwise the
reference's).  Bars: configs and data exact; energies, forces, the loss
and every gradient of the loss (a gradient through the forces, which are
themselves a gradient) at rtol 1e-4 / atol 1e-5, each gradient's atol
taken relative to its largest entry, at the smoke config
(correlation order 2) and at the published width (d_hidden 128, order 3)
on small graphs with self edges; the equivariance property of
tests/test_models_smoke.py at 1e-4; five trainer steps held from the
reference's own state, as tests/test_torch_recsys.py holds the recsys
trainer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prophelpers import rand_rotation
from repro import configs as jax_configs
from repro import train as jax_train
from repro.ckpt.checkpoint import _flatten_with_paths as jax_flatten
from repro.data import graph as jax_graph
from repro.models import mace as JM
from repro_torch import configs
from repro_torch import tree as T
from repro_torch.convert import mace_params_from_numpy
from repro_torch.data import graph
from repro_torch.launch import train as train_cli
from repro_torch.models import mace as MA
from repro_torch.train import (adam, apply_updates, clip_by_global_norm,
                               value_and_grad)
import torch_threads  # noqa: F401  (PyTorch threads per test process)

F32 = dict(rtol=1e-4, atol=1e-5)
EQUI = 1e-4


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _configs(full):
    if full:
        return (jax_configs.get_bundle("mace").config,
                configs.get_bundle("mace").config)
    return jax_configs.smoke("mace"), configs.smoke("mace")


def _params(full, seed=0):
    jc, c = _configs(full)
    jp = JM.init_params(jc, jax.random.key(seed))
    return jc, c, jp, mace_params_from_numpy(jax.tree.map(np.asarray, jp),
                                             c, device="cpu")


def _batch(c, n_graphs, nodes, edges, seed):
    b = graph.batched_molecules(n_graphs, nodes, edges, seed=seed,
                                n_species=c.n_species)
    b["energy"] = np.sin(np.arange(n_graphs, dtype=np.float32))
    b["forces"] = np.random.RandomState(seed).randn(
        *b["positions"].shape).astype(np.float32) * 0.1
    return b


def _grads_match(got, want, scaled=True):
    """Leaf by leaf at rtol 1e-4 / atol 1e-5; with ``scaled`` the atol is
    relative to the leaf's largest entry.  MACE's gradients reach 4e3,
    and one taken through its forces carries float32 noise of the same
    relative size: the reference's own jitted and op-by-op gradients
    part by up to 4x the unscaled bar on a near-zero entry of such a
    leaf (at 1e-6 of the leaf's norm; the port's part by 1e-6 - 8e-6)."""
    g, w = T.flatten_with_paths(got), jax_flatten(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (n, a), (_, b) in zip(g, w):
        b = np.asarray(b)
        top = float(np.abs(b).max(initial=0.0)) if scaled else 1.0
        np.testing.assert_allclose(_np(a), b, rtol=F32["rtol"],
                                   atol=F32["atol"] * max(top, 1.0),
                                   err_msg=n)


# ---------------------------------------------------------------------------
# config and data
# ---------------------------------------------------------------------------

def test_mace_configs_match_jax():
    for full in (True, False):
        c, jc = _configs(full)[1], _configs(full)[0]
        assert type(c).__name__ == type(jc).__name__ == "MACEConfig"
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    b, jb = configs.get_bundle("mace"), jax_configs.get_bundle("mace")
    assert b.domain == jb.domain == "gnn"
    assert b.shape("molecule") == configs.GNN_SHAPES[3]
    assert dataclasses.asdict(b.shape("molecule")) == \
        dataclasses.asdict(jb.shape("molecule"))


@pytest.mark.parametrize("seed", [0, 5, 31])
def test_graph_data_is_the_references(seed):
    """``batched_molecules``, ``random_graph``, ``NeighborSampler.sample``
    (fanouts 15-10 and 5-3, isolated nodes included) and
    ``subgraph_shape`` bitwise."""
    for args in ((8, 12, 32), (128, 30, 64), (3, 5, 1)):
        got = graph.batched_molecules(*args, seed=seed, n_species=16)
        want = jax_graph.batched_molecules(*args, seed=seed, n_species=16)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    g = graph.random_graph(700, 2000, seed=seed)
    jg = jax_graph.random_graph(700, 2000, seed=seed)
    assert g.n_nodes == jg.n_nodes and g.n_edges == jg.n_edges
    for name in ("senders", "receivers", "positions", "species"):
        a, b = getattr(g, name), getattr(jg, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # senders below 500 only: nodes 500-699 have no neighbour
    g.senders, jg.senders = g.senders % 500, jg.senders % 500
    for fanout in ((15, 10), (5, 3)):
        seeds = np.arange(0, 700, 23)
        got = graph.NeighborSampler(g).sample(seeds, fanout, seed=seed)
        want = jax_graph.NeighborSampler(jg).sample(seeds, fanout, seed=seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert graph.subgraph_shape(seeds.size, fanout) == \
            jax_graph.subgraph_shape(seeds.size, fanout)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_has_the_references_layout():
    for full in (False, True):
        jc, c, jp, tp = _params(full)
        got = MA.init_params(c, torch.Generator().manual_seed(0), "cpu")
        names = [n for n, _ in jax_flatten(jp)]
        assert [n for n, _ in T.flatten_with_paths(got)] == names
        assert [n for n, _ in T.flatten_with_paths(tp)] == names
        for (n, a), (_, w) in zip(T.flatten_with_paths(got),
                                  jax_flatten(jp)):
            assert tuple(a.shape) == w.shape, n
    bad = jax.tree.map(np.asarray, jp)
    bad["layers"] = bad["layers"][:1]
    with pytest.raises(ValueError, match="layout"):
        mace_params_from_numpy(bad, c, device="cpu")


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "published"])
def test_energies_forces_and_loss_gradients_match_jax(full):
    """Energies, forces and every gradient of ``mace_loss`` at rtol 1e-4 /
    atol 1e-5, on molecules whose random edges include self edges (the
    degenerate-edge guard keeps their second derivative finite)."""
    jc, c, jp, tp = _params(full, seed=1)
    n_graphs = 3
    b = _batch(c, n_graphs, 9, 24, seed=2)
    assert (b["senders"] == b["receivers"]).any()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    je, jf = jax.jit(lambda p, x: JM.energy_and_forces(
        p, jc, n_graphs=n_graphs, **{k: x[k] for k in MA.INPUTS}))(jp, jb)
    with torch.no_grad():
        te, tf = MA.energy_and_forces(tp, c, n_graphs=n_graphs,
                                      **{k: tb[k] for k in MA.INPUTS})
    assert not te.requires_grad and not tf.requires_grad
    np.testing.assert_allclose(_np(te), np.asarray(je), **F32)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), **F32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, x: JM.mace_loss(p, jc, x, n_graphs)))(jp, jb)
    loss, grads = value_and_grad(train_cli.gnn_loss_fn(c, n_graphs), tp, tb)
    np.testing.assert_allclose(float(loss), float(jl), **F32)
    _grads_match(grads, jg)
    assert all(bool(torch.isfinite(g).all()) for g in T.leaves(grads))
    # mix_t feeds nothing, in either package
    assert all(float(lp["mix_t"].abs().max()) == 0.0
               for lp in grads["layers"])


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "published"])
@pytest.mark.parametrize("seed", [0, 1])
def test_equivariance_property(full, seed):
    """tests/test_models_smoke.py's property at 1e-4: under a random
    rotation and translation the energies stay and the forces rotate."""
    _, c, _, tp = _params(full)
    rng = np.random.RandomState(seed)
    n = 24
    pos = torch.from_numpy((rng.randn(n, 3) * 2).astype(np.float32))
    snd = rng.randint(0, n, 3 * n)
    rcv = (snd + 1 + rng.randint(0, n - 1, 3 * n)) % n
    kw = dict(species=torch.from_numpy(rng.randint(0, c.n_species, n)),
              senders=torch.from_numpy(snd), receivers=torch.from_numpy(rcv),
              graph_idx=torch.zeros(n, dtype=torch.int32), n_graphs=1)
    rot = torch.from_numpy(rand_rotation(seed))
    shift = torch.from_numpy(rng.randn(3).astype(np.float32))
    with torch.no_grad():
        e1, f1 = MA.energy_and_forces(tp, c, positions=pos, **kw)
        e2, f2 = MA.energy_and_forces(tp, c, positions=pos @ rot.T + shift,
                                      **kw)
    scale = max(float(f1.abs().max()), 1e-3)
    assert abs(float(e1[0] - e2[0])) < EQUI * max(abs(float(e1[0])), 1.0)
    assert float((f2 - f1 @ rot.T).abs().max()) / scale < EQUI


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def test_train_gnn_steps_match_jax():
    """Five steps of the reference's ``train_gnn`` recipe held from its
    own state: its batches (``gnn_batches``: ``batched_molecules(8, 12,
    32, seed=step)``, targets sin(0..7) and zero forces), at its
    parameters the port's loss and every gradient, then the port's
    clipping and ``adam(1e-3)`` update of its gradients and moments give
    its next parameters (``make_train_step``'s pieces in one jitted
    function, as tests/test_torch_recsys.py)."""
    jc, c, jp, _ = _params(False)
    n_graphs = train_cli.GNN_BATCH[0]
    jopt = jax_train.adam(1e-3)

    @jax.jit
    def jstep(p, o, b):
        loss, g = jax.value_and_grad(
            lambda p, b: JM.mace_loss(p, jc, b, n_graphs=n_graphs))(p, b)
        clipped, norm = jax_train.clip_by_global_norm(g, 1.0)
        upd, o_next = jopt.update(clipped, o, p)
        return loss, g, norm, jax_train.apply_updates(p, upd), o_next

    jo = jopt.init(jp)
    opt = adam(train_cli.GNN_LR)
    batches = train_cli.gnn_batches(c, 0, "cpu")
    to_port = lambda tree: mace_params_from_numpy(
        jax.tree.map(np.asarray, tree), c, device="cpu")
    for i in range(5):
        batch = batches(i)
        ref = jax_graph.batched_molecules(*train_cli.GNN_BATCH, seed=i,
                                          n_species=jc.n_species)
        for k, v in ref.items():
            np.testing.assert_array_equal(batch[k].numpy(), v, err_msg=k)
        jb = {k: jnp.asarray(v) for k, v in ref.items()}
        jb["energy"] = jnp.sin(jnp.arange(n_graphs, dtype=jnp.float32))
        jb["forces"] = jnp.zeros_like(jb["positions"])
        np.testing.assert_array_equal(batch["energy"].numpy(),
                                      np.asarray(jb["energy"]))
        assert not batch["forces"].any()
        jl, jg, jnorm, jp_next, jo_next = jstep(jp, jo, jb)
        at = to_port(jp)
        loss, g = value_and_grad(train_cli.gnn_loss_fn(c, n_graphs), at,
                                 batch)
        np.testing.assert_allclose(float(loss), float(jl), **F32)
        _grads_match(g, jg)
        clipped, norm = clip_by_global_norm(to_port(jg), 1.0)
        np.testing.assert_allclose(float(norm), float(jnorm), **F32)
        upd, _ = opt.update(clipped, _to_torch(jo), at)
        _grads_match(apply_updates(at, upd), jp_next, scaled=False)
        jp, jo = jp_next, jo_next


def test_train_gnn_draws_its_weights_from_the_seed():
    c = configs.smoke("mace")
    res = train_cli.train_gnn(2, None, seed=3, device="cpu", verbose=False)
    init = MA.init_params(c, torch.Generator().manual_seed(3), "cpu")
    loss = train_cli.gnn_loss_fn(c, 8)(init,
                                       train_cli.gnn_batches(c, 3, "cpu")(0))
    assert res.history[0]["loss"] == pytest.approx(loss.item(), rel=1e-6)
    assert res.state.step == 2
