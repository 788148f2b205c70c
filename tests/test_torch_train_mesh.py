"""Training under a mesh on the CPU: placed steps against the mesh-less
port.

Spawned gloo worlds of 4 and 3 ranks (``torch_mesh_ranks``, each on a
``FileStore``, joined with a timeout) run meshes (2, 2) and (1, 3): the
smoke stablelm's train step under ``fsdp`` and ``tp2d``, the smoke
granite-moe's under ``fsdp`` (the MoE dispatch over every axis, the
expert weights split) and ``tp2d`` (experts over ``model`` on (2, 2),
capacity rows over ``model`` on (1, 3): each rank builds its part of
the dispatch buffer), MACE on 3 padded molecules and a DLRM step, each
placed by its cell's ``in_shardings`` from the mesh-less cell's
arguments.  Loss, grad norm and Adam's moments after the step (0.1 g
and 0.001 g^2: the gradients) match the mesh-less step at the float32
bar, rtol 1e-5 / atol 1e-6 of each tree's largest entry; Adam's update
is checked from the same state (the mesh-less gradients and moments
placed), because one Adam step turns order-dependent rounding of a
near-zero gradient into a full step.  The mesh-less steps are held
against JAX in ``tests/test_torch_launch.py``.  A decode step on a cache
split over the sequence and the batch matches the mesh-less step, and
MACE's forward on placed inputs (each rank's nodes and edges) the
mesh-less energies.  MACE's placed step is held at
``tests/test_torch_mace.py``'s float32 bar (rtol 1e-4 / atol 1e-5): each
rank sums its own edges and nodes and the parts are added, a float32
order of its own (``tests/test_torch_mace_mesh.py`` holds it at 1e-10 in
float64).
On
(2, 2) also ``fit``
of three steps on placed state against the mesh-less ``fit``, its
DTensor checkpoint restored onto a (4, 1) mesh bitwise.
"""
import json
import os

import numpy as np
import pytest

import torch_mesh_ranks as R
import torch_threads  # noqa: F401  (PyTorch threads per test process)

TOL = dict(rtol=1e-5, atol=1e-6)
# MACE sums each rank's edges and nodes apart and adds the parts: its
# float32 bar is tests/test_torch_mace.py's
MACE_TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = ((2, 2), (1, 3))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    worlds = []
    for shape in SHAPES:
        work = str(tmp_path_factory.mktemp("x".join(map(str, shape))))
        tasks = {"train": [list(shape)]}
        if shape == (2, 2):
            tasks["fit"] = list(shape)
        with open(os.path.join(work, "tasks.json"), "w") as f:
            json.dump(tasks, f)
        worlds.append((shape[0] * shape[1], work))
    out = R.run_worlds(worlds)
    return {shape: (out[i], worlds[i][1]) for i, shape in enumerate(SHAPES)}


def _close(a, b, what, tol=TOL):
    scale = max(float(np.abs(a).max()), 1e-30)
    np.testing.assert_allclose(b, a, rtol=tol["rtol"],
                               atol=tol["atol"] * scale, err_msg=what)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", R.TRAIN_CASES, ids="/".join)
def test_placed_step_matches_the_meshless_step(ranks, shape, case):
    """Every rank's loss, grad norm and moments equal the mesh-less
    step's; the parameters came back placed."""
    tag = "x".join(map(str, shape))
    key = f"train/{tag}/{case[0]}/{case[1]}"
    tol = MACE_TOL if case[0] == "mace" else TOL
    outs, _ = ranks[shape]
    for out in outs:
        for name in [k for k in out if k.startswith(key + "/metric/")]:
            ref, got = out[name]
            np.testing.assert_allclose(got, ref, **tol, err_msg=name)
        refs = [k for k in out if k.startswith(key + "/")
                and k.endswith("/ref")]
        assert refs
        for k in refs:
            _close(out[k], out[k[:-4] + "/got"], k, tol)
        assert int(out[f"{key}/placed"]) > 0


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_adam_update_on_the_mesh_from_the_same_state(ranks, shape):
    tag = "x".join(map(str, shape))
    outs, _ = ranks[shape]
    for out in outs:
        keys = [k for k in out if k.startswith(f"update/{tag}/")
                and k.endswith("/ref")]
        assert len(keys) > 5
        for k in keys:
            _close(out[k], out[k[:-4] + "/got"], k)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_placed_decode_matches_the_meshless_step(ranks, shape):
    """A decode step on a cache split over the sequence (``model``) and
    the batch (``data``): its logits and the written cache against the
    mesh-less step's, for the dense and the MoE smoke LM."""
    tag = "x".join(map(str, shape))
    outs, _ = ranks[shape]
    for out in outs:
        keys = [k for k in out if k.startswith(f"decode/{tag}/")
                and k.endswith("/ref")]
        assert len(keys) == 6
        for k in keys:
            _close(out[k], out[k[:-4] + "/got"], k)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_placed_mace_energies_match_the_meshless_forward(ranks, shape):
    """MACE's forward on placed inputs (its nodes and edges split over
    every axis, as the cell places them; each rank runs its own) gives
    the mesh-less energies."""
    tag = "x".join(map(str, shape))
    outs, _ = ranks[shape]
    for out in outs:
        _close(out[f"energy/{tag}/ref"], out[f"energy/{tag}/got"], tag)


def test_fit_on_placed_state_matches_meshless_fit(ranks):
    """Three steps of ``fit``: every rank's losses and final parameters
    against the mesh-less ``fit`` (the losses at the float32 bar, the
    parameters within 1e-5 of their largest entry: three Adam steps)."""
    outs, _ = ranks[(2, 2)]
    for out in outs:
        np.testing.assert_allclose(out["fit/mesh/loss"],
                                   out["fit/plain/loss"], **TOL)
        for k in [k for k in out if k.startswith("fit/plain/params/")]:
            a, b = out[k], out[k.replace("/plain/", "/mesh/")]
            np.testing.assert_allclose(
                b, a, rtol=1e-5, atol=1e-5 * float(np.abs(a).max()),
                err_msg=k)


def test_placed_checkpoint_restores_on_another_mesh_bitwise(ranks):
    """The meshed ``fit``'s checkpoint (rank 0 wrote whole tensors)
    read onto a (4, 1) mesh: every leaf's whole tensor is the meshed
    run's final parameter, bitwise; and saved from there again, the
    files equal."""
    outs, work = ranks[(2, 2)]
    assert sorted(int(o["fit/rank"]) for o in outs) == [0, 1, 2, 3]
    for out in outs:
        assert int(out["fit/restored/step"]) == 3
        for k in [k for k in out if k.startswith("fit/restored/params/")]:
            np.testing.assert_array_equal(
                out[k], out[k.replace("fit/restored/", "fit/mesh/")])
    a = np.load(os.path.join(work, "fit_mesh", "ckpt_0000000003",
                             "arrays.npz"))
    b = np.load(os.path.join(work, "fit_again", "ckpt_0000000003",
                             "arrays.npz"))
    params = [k for k in a.files if k.startswith("params/")]
    assert params and all(np.array_equal(a[k], b[k]) for k in params)
