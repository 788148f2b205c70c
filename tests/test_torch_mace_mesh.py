"""MACE partitioned on a mesh, on the CPU: each rank's nodes and edges
against the mesh-less port and the JAX package.

Spawned gloo worlds of 4 and 3 ranks (``torch_mesh_ranks``, task
``mace``) run meshes (2, 2) and (1, 3) on two graphs that
``launch.steps._mace_cell`` pads to 1,024 nodes and 1,536 edges: a
random graph of 700 nodes and 1,500 edges, whose edges cross every
rank's block of nodes, and 40 molecules of 13 atoms, which straddle the
blocks (on (1, 3) the blocks are 342, 342 and 340 rows, DTensor's
``Shard(0)``).  The parameters are the reference's draw
(``convert.mace_params_from_numpy``), at the smoke widths with
correlation order 3; the force targets are random.  Each rank's loss,
every gradient of it (a gradient through the forces, themselves a
gradient), the energies and its rows of the forces match the mesh-less
port at rtol 1e-10 of each leaf's largest entry in float64, and in
float32 at ``tests/test_torch_mace.py``'s bar (rtol 1e-4 / atol 1e-5 of
the largest entry), where they also match the JAX package's
``mace_loss`` by ``jax.value_and_grad`` and its ``energy_and_forces``.
The energies of placed parameters and plain (whole) inputs match too.
The gradients come back whole (``Replicate()``), and the step ran
``dist.collective``'s three Functions.  On the (2, 2) world the three
pass ``gradcheck`` and ``gradgradcheck`` in float64, as functions of a
tensor whole on every rank, at row counts that leave ranks with fewer
rows and with none.
"""
import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.ckpt.checkpoint import _flatten_with_paths as jax_flatten
from repro.models import mace as JM
from repro_torch import tree as T
from repro_torch.convert import mace_params_from_numpy
from repro_torch.models import mace as MA
from repro_torch.train.loop import value_and_grad
import torch_mesh_ranks as R
import torch_threads  # noqa: F401  (PyTorch threads per test process)

SHAPES = ((2, 2), (1, 3))
GRAPHS = tuple(R.mace_graphs())
F64 = 1e-10
F32 = dict(rtol=1e-4, atol=1e-5)
FUNCTIONS = ("all_gather_rows", "reduce_scatter_rows", "all_reduce_sum")


def _tag(shape):
    return "x".join(map(str, shape))


def _meshless(params, graph: str, dtype: str) -> dict:
    """The mesh-less port's loss, gradients, energies and forces."""
    cfg = R.mace_cfg()
    n_graphs = R.mace_graphs()[graph].n_graphs or 1
    p = R.mace_cast(params, dtype)
    b = R.mace_cast(R.mace_batch(graph), dtype)
    torch.use_deterministic_algorithms(True)
    try:
        loss, grads = value_and_grad(
            lambda p, b: MA.mace_loss(p, cfg, b, n_graphs), p, b)
        with torch.no_grad():
            e, f = MA.energy_and_forces(p, cfg, n_graphs=n_graphs,
                                        **{k: b[k] for k in MA.INPUTS})
    finally:
        torch.use_deterministic_algorithms(False)
    return {"loss": loss.numpy(), "energy": e.numpy(), "forces": f.numpy(),
            **{f"grad/{n}": g.numpy() for n, g in
               T.flatten_with_paths(grads)}}


def _reference(jcfg, jp, graph: str) -> dict:
    """The JAX package's loss, gradients, energies and forces (float32)."""
    n_graphs = R.mace_graphs()[graph].n_graphs or 1
    jb = {k: jnp.asarray(v) for k, v in R.mace_batch(graph).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, x: JM.mace_loss(p, jcfg, x, n_graphs)))(jp, jb)
    e, f = jax.jit(lambda p, x: JM.energy_and_forces(
        p, jcfg, n_graphs=n_graphs, **{k: x[k] for k in MA.INPUTS}))(jp, jb)
    return {"loss": np.asarray(loss), "energy": np.asarray(e),
            "forces": np.asarray(f),
            **{f"grad/{n}": np.asarray(g) for n, g in jax_flatten(grads)}}


@pytest.fixture(scope="module")
def mace(tmp_path_factory):
    """The worlds' outputs (``ranks``), the mesh-less port's
    (``meshless``, by graph and dtype) and the JAX package's
    (``reference``, by graph), the last two computed while the worlds
    run."""
    jcfg = dataclasses.replace(jax_configs.smoke("mace"),
                               correlation_order=3)
    jp = JM.init_params(jcfg, jax.random.key(0))
    params = mace_params_from_numpy(jax.tree.map(np.asarray, jp),
                                    R.mace_cfg(), device="cpu")
    worlds = []
    for shape in SHAPES:
        work = str(tmp_path_factory.mktemp("mace" + _tag(shape)))
        torch.save(params, os.path.join(work, "mace_params.pt"))
        tasks = {"mace": list(shape), "collectives": shape == (2, 2)}
        with open(os.path.join(work, "tasks.json"), "w") as f:
            json.dump(tasks, f)
        worlds.append((shape[0] * shape[1], work))
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(R.run_worlds, worlds)
        meshless = {(g, d): _meshless(params, g, d) for g in GRAPHS
                    for d in R.MACE_DTYPES}
        reference = {g: _reference(jcfg, jp, g) for g in GRAPHS}
        out = running.result()
    return dict(meshless=meshless, reference=reference,
                ranks={shape: out[i] for i, shape in enumerate(SHAPES)})


def _close(got, want, what, dtype):
    top = float(np.abs(want).max(initial=0.0))
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=F64, atol=F64 * top,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=F32["rtol"],
                                   atol=F32["atol"] * max(top, 1.0),
                                   err_msg=what)


def _check_rank(out, key, want, dtype):
    """One rank's outputs under ``key`` against ``want`` (whole tensors;
    the forces are this rank's rows)."""
    lo, hi = (int(v) for v in out[f"{key}/rows"])
    assert tuple(out[f"{key}/forces_shape"]) == want["forces"].shape
    _close(out[f"{key}/forces"], want["forces"][lo:hi], f"{key}/forces",
           dtype)
    for name in ("loss", "energy"):
        _close(out[f"{key}/{name}"], want[name], f"{key}/{name}", dtype)
    _close(out[f"{key}/energy_of_whole_inputs"], want["energy"],
           f"{key}/energy_of_whole_inputs", dtype)
    grads = [k for k in want if k.startswith("grad/")]
    assert grads and sorted(grads) == sorted(
        k[len(key) + 1:] for k in out if k.startswith(f"{key}/grad/"))
    for k in grads:
        _close(out[f"{key}/{k}"], want[k], f"{key}/{k}", dtype)


@pytest.mark.parametrize("dtype", R.MACE_DTYPES)
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_meshed_mace_matches_the_meshless_port(mace, shape, graph, dtype):
    """Every rank's loss, gradients, energies and rows of the forces
    against the mesh-less port: rtol 1e-10 in float64, the float32 bar
    in float32."""
    key = f"mace/{_tag(shape)}/{graph}/{dtype}"
    for out in mace["ranks"][shape]:
        _check_rank(out, key, mace["meshless"][(graph, dtype)], dtype)


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_meshed_mace_matches_jax(mace, shape, graph):
    """The float32 step on the mesh against the JAX package's
    ``jax.value_and_grad`` of ``mace_loss`` and its ``energy_and_forces``
    at the float32 bar; ``mix_t`` feeds nothing in either."""
    key = f"mace/{_tag(shape)}/{graph}/float32"
    for out in mace["ranks"][shape]:
        _check_rank(out, key, mace["reference"][graph], "float32")
        assert all(float(np.abs(out[k]).max()) == 0.0 for k in out
                   if k.startswith(f"{key}/grad/") and "mix_t" in k)


@pytest.mark.parametrize("shape", SHAPES, ids=_tag)
def test_meshed_gradients_are_whole_and_the_collectives_ran(mace, shape):
    """Each gradient comes back ``Replicate()`` (the partial sums summed
    once), and every step ran each of the three Functions."""
    for out in mace["ranks"][shape]:
        keys = [k for k in out if "/whole/" in k]
        assert keys and all(bool(out[k]) for k in keys)
        for graph in GRAPHS:
            for dtype in R.MACE_DTYPES:
                launches = out[f"mace/{_tag(shape)}/{graph}/{dtype}/launches"]
                assert (launches > 0).all(), launches


@pytest.mark.parametrize("n", R.COLLECTIVE_ROWS)
@pytest.mark.parametrize("name", FUNCTIONS)
def test_collectives_pass_gradcheck_and_gradgradcheck(mace, name, n):
    """``gradcheck`` and ``gradgradcheck`` of each Function over the 4
    ranks of the (2, 2) world, on every rank."""
    for out in mace["ranks"][(2, 2)]:
        assert bool(out[f"collective/{n}/{name}/grad"])
        assert bool(out[f"collective/{n}/{name}/gradgrad"])
