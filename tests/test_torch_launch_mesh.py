"""The launch tools under a mesh on the CPU, against the JAX package.

* Placement: for all 42 cells on the (16, 16) and (2, 16, 16) meshes, and
  the LM training cells under ``strategy="fsdp"``, the port's
  ``in_shardings`` resolved on an ``AbstractMesh`` equal the reference's
  ``PartitionSpec`` s entry for entry, and the microbatching and FSDP
  sequence-axis choices (``meta``) the reference's.  The reference's come
  from a subprocess started with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=512`` (its
  ``build_cell`` wants a real mesh of that many devices).
* ``maybe_constrain`` / ``maybe_replicate``, ``collective_bytes`` and the
  per-device flops, in subprocesses on worlds of 4 and 3 ranks of
  torch's ``fake`` backend (a process joins one world, and this one may
  join a gloo world in another test), on meta DTensors
  (``torch_mesh_ranks.fake_world_checks``); ``x.sum()`` on ``x`` sharded
  4 ways moves the bytes the reference's ``collective_bytes`` parses from
  the HLO of the same program on 4 forced host devices; MACE's training
  step on a (2, 2) mesh counts a quarter of its one-device flops, no
  local op on every edge, and the collectives' closed form.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.dist.sharding import AbstractMesh, NamedSharding
from repro_torch.launch import steps as S
import torch_threads  # noqa: F401  (PyTorch threads per test process)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

REFERENCE = r"""
import dataclasses, functools, json, sys
import jax, jax.numpy as jnp
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import all_cell_ids, build_cell
from repro.configs import get_bundle
from repro.models import transformer as JT

# the reference's init_params traced at one layer and widened to the
# config's layers (as tests/test_torch_launch.py does): the same shapes
# in a fraction of the trace time of the MoE configs
real_init = JT.init_params

@functools.lru_cache(maxsize=None)
def one_layer(name):
    cfg = get_bundle(name).config
    return jax.eval_shape(lambda: real_init(
        dataclasses.replace(cfg, n_layers=1), jax.random.key(0)))

def stacked_init(cfg, key):
    def full(path, s):
        lead = (cfg.n_layers,) if path[0].key == "layers" else ()
        return jnp.zeros(lead + s.shape[len(lead):], s.dtype)
    return jax.tree_util.tree_map_with_path(full, one_layer(cfg.name))

JT.init_params = stacked_init

def norm(spec):
    out = []
    for e in spec:
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else list(e)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return out

def key(k):
    for a in ("key", "idx", "name"):
        if hasattr(k, a):
            return str(getattr(k, a))
    return str(k)

def lm_train(a, s):
    if a == "seine":
        return False
    b = get_bundle(a)
    return b.domain == "lm" and b.shape(s).kind == "training"

out = {}
for mesh_name, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for a, s in all_cell_ids():
        for strategy in ("tp2d", "fsdp"):
            if strategy == "fsdp" and not lm_train(a, s):
                continue
            with jax.set_mesh(mesh):
                c = build_cell(a, s, mesh, strategy=strategy)
            leaves = jax.tree_util.tree_flatten_with_path(c.in_shardings)[0]
            out[f"{a}/{s}/{mesh_name}/{strategy}"] = {
                "specs": {"/".join(key(k) for k in path): norm(sh.spec)
                          for path, sh in leaves},
                "meta": {k: c.meta.get(k) for k in ("accum", "microbatch")}}
json.dump(out, sys.stdout)
"""

SUM_HLO = r"""
import json, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.launch.roofline import collective_bytes
mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
f = jax.jit(lambda x: x.sum(), in_shardings=NamedSharding(mesh, P("d")),
            out_shardings=NamedSharding(mesh, P()))
c = f.lower(jax.ShapeDtypeStruct((64, 8), jnp.float32)).compile()
json.dump(collective_bytes(c.as_text()), sys.stdout)
"""


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
                JAX_PLATFORMS="cpu", **extra)


def _reference(script: str, devices: int) -> dict:
    env = _env(XLA_FLAGS=f"--xla_force_host_platform_device_count="
               f"{devices}")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


@pytest.fixture(scope="module")
def reference_cells():
    return _reference(REFERENCE, 512)


def _norm(spec) -> list:
    out = [list(e) if isinstance(e, tuple) and len(e) > 1 else
           (e[0] if isinstance(e, tuple) else e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def _port_specs(tree, path=()) -> dict:
    """``{path: spec}`` of a tree of NamedShardings, keyed as
    ``jax.tree_util``'s paths render (dict keys sorted, named-tuple and
    dataclass fields by name, sequences by index)."""
    if isinstance(tree, NamedSharding):
        return {"/".join(path): _norm(tree.spec)}
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    elif hasattr(tree, "__dataclass_fields__"):
        items = [(f, getattr(tree, f)) for f in tree.__dataclass_fields__]
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(_port_specs(v, path + (str(k),)))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_in_shardings_match_the_reference(reference_cells, mesh_name):
    """Every cell's ``in_shardings`` (parameters, optimizer state, batch;
    SEINE's index and inputs) and its microbatching, entry for entry."""
    mesh = AbstractMesh(*MESHES[mesh_name])
    n = 0
    for key, ref in reference_cells.items():
        arch, shape, m, strategy = key.split("/")
        if m != mesh_name:
            continue
        cell = S.build_cell(arch, shape, mesh, strategy=strategy)
        got = _port_specs(cell.in_shardings)
        assert got == ref["specs"], key
        for k, v in ref["meta"].items():
            assert cell.meta.get(k) == v, (key, k)
        n += 1
    assert n == 42 + sum(S.is_lm_training(*c) for c in S.all_cell_ids())


def test_fsdp_moves_pod_to_the_sequence():
    """FSDP over (2, 16, 16) at a batch of 256: the grid of 512 does not
    divide it, so the batch splits over (data, model) and the sequence
    over pod; on (16, 16) the batch takes the whole grid."""
    multi = AbstractMesh(*MESHES["multi"])
    assert S.lm_batch_axes(multi, 256, "fsdp") == (("data", "model"), "pod")
    assert S.lm_batch_axes(multi, 512, "fsdp") == (
        ("pod", "data", "model"), None)
    assert S.lm_batch_axes(multi, 256, "tp2d") == (("pod", "data"), None)
    single = AbstractMesh(*MESHES["single"])
    assert S.lm_batch_axes(single, 256, "fsdp") == (("data", "model"), None)


def _fake_checks() -> dict:
    """``torch_mesh_ranks.fake_world_checks`` in two processes at once,
    worlds of 4 and 3 fake ranks."""
    procs = {n: subprocess.Popen(
        [sys.executable, "-c", "import sys, json, torch_mesh_ranks as R; "
         f"json.dump(R.fake_world_checks({n}), sys.stdout)"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for n in (4, 3)}
    out = {}
    for n, p in procs.items():
        stdout, stderr = p.communicate(timeout=240)
        assert p.returncode == 0, stderr[-3000:]
        out[n] = json.loads(stdout)
    return out


@pytest.fixture(scope="module")
def fake_checks():
    return _fake_checks()


def test_hints_resolve_as_the_reference(fake_checks):
    """``maybe_constrain``: ``__data__`` and ``__all__`` expand to the
    axes present, an axis tuple that does not divide shrinks from the
    left ('pod' first) and is dropped when nothing divides, mesh axes no
    entry names are replicated; with no mesh, or on a plain tensor, the
    same object comes back.  ``maybe_replicate`` replicates on every mesh
    dimension."""
    four, three = fake_checks[4], fake_checks[3]
    assert four["no_mesh_same"] and four["plain_same"]
    assert four["data_model"] == ["S0", "S1"]
    assert four["all_rows"] == ["S0", "S0"]
    assert four["pod_shrunk"] == ["R", "S0", "S0"]
    assert four["nothing_divides_same"]
    assert four["replicate"] == ["R", "R"]
    assert three["model_rows"] == ["R", "S0"]
    assert three["model_not_dividing_same"]
    assert three["data_absent_same"]


def test_replicate_backward_is_a_reduce_scatter(fake_checks):
    """The gradient of an FSDP weight gathered by ``maybe_replicate`` and
    used on a batch split over the mesh leaves through a reduce-scatter
    (the forward's gather is an all-gather)."""
    four = fake_checks[4]
    assert set(four["replicate_fwd"]) == {"all-gather", "total"}
    assert four["replicate_bwd"]["reduce-scatter"] > 0
    assert four["grad_placements"] == ["S0", "S0"]


def test_collective_bytes_by_op(fake_checks):
    """Result bytes by op on a 4-rank mesh: the all-gather of an (8, 16)
    float32 weight split on rows is the whole weight, the all-reduce of a
    partial (4, 16) product its whole result, the reduce-scatter of a
    partial (8, 16) gradient one rank's rows."""
    four = fake_checks[4]
    assert four["gather"] == {"all-gather": 512.0, "total": 512.0}
    assert four["reduce"] == {"all-reduce": 256.0, "total": 256.0}
    assert four["scatter"] == {"reduce-scatter": 128.0, "total": 128.0}


def test_sum_collective_matches_the_reference_hlo(fake_checks):
    """``x.sum()`` on x (64, 8) split 4 ways: the port's collectives by
    op equal the reference's ``collective_bytes`` of the compiled HLO on
    4 forced host devices."""
    assert fake_checks[4]["sum"] == _reference(SUM_HLO, 4)


def test_flops_are_the_local_products(fake_checks):
    """A (64, 32) x (32, 16) product with its rows split 4 ways: one
    device's flops are the global count over 4, where a
    ``FlopCounterMode`` above the DTensor counts the global product."""
    four = fake_checks[4]
    assert four["global_flops"] == 2 * 64 * 32 * 16
    assert four["local_flops"] == four["global_flops"] // 4
    assert four["mode_above_flops"] == four["global_flops"]


def test_moe_dispatch_runs_on_each_ranks_groups(fake_checks):
    """The MoE layer with its token groups split over a (2, 2) mesh
    (``batch_axes="__all__"``): each rank routes, dispatches and combines
    its own groups, so one device's flops are the mesh-less count over 4,
    its eager bytes within 10% of that share, and its only collectives
    are all-reduces over both mesh axes: of the aux loss's two (E,)
    float32 means, and of the replicated router's (D, E) gradient (no
    gather of the batch); the smoke granite-moe's FSDP training step counts the
    mesh-less step's flops over 4 a device."""
    four = fake_checks[4]
    whole, dev = four["moe_flops"]
    assert dev == whole / 4
    whole_b, dev_b = four["moe_bytes"]
    assert dev_b <= 1.1 * whole_b / 4
    coll = four["moe_coll"]
    assert set(coll) == {"all-reduce", "total"}
    n_e, d = four["n_experts"], four["d_model"]
    assert coll["all-reduce"] <= 2 * (2 * 4 * n_e + 4 * d * n_e)
    cell_whole, cell_dev = four["moe_cell_flops"]
    assert cell_dev == cell_whole / 4


def test_mace_runs_each_ranks_nodes_and_edges(fake_checks):
    """MACE's training step at its published config (d_hidden 128, 2
    layers, correlation 3) on a random graph of 1,024 nodes and 1,536
    edges placed on a (2, 2) mesh: one device's flops are at most 0.3 of
    the one-device count (its own quarter of the nodes and edges), no
    local op holds a tensor of every edge, and its collectives' result
    bytes are the design's closed form.  With W ranks of B = ceil(N / W)
    node rows, C channels, L layers, G graphs and f = 4 bytes: the
    forward gathers the positions (3 columns) and each layer's mixed
    (h_s, h_v) (4C) and reduce-scatters its (A_s, A_v, A_t) (13C); the
    forces' backward gathers each layer's A gradients and reduce-scatters
    the (h_s, h_v) gradients of the layers after the first and the
    positions'; the loss's backward runs each of those Functions'
    backward once more.  So all-gather W B f (6 + (34 L - 4) C),
    reduce-scatter B f (3 + (34 L - 4) C), and all-reduce f (G + 1 +
    the parameters the loss reads): the energies, the force term and
    the partial gradients summed once."""
    four = fake_checks[4]
    whole, dev = four["mace_flops"]
    assert dev <= 0.3 * whole
    assert four["mace_edge_ops"] == []
    z = four["mace_sizes"]
    w, f = 4, 4
    b = -(-z["n_nodes"] // w)
    c, n_l = z["d_hidden"], z["n_layers"]
    per = (34 * n_l - 4) * c
    assert four["mace_coll"] == {
        "all-gather": float(w * b * f * (6 + per)),
        "reduce-scatter": float(b * f * (3 + per)),
        "all-reduce": float(f * (z["n_graphs"] + 1 + z["n_params_read"])),
        "total": float(w * b * f * (6 + per) + b * f * (3 + per)
                       + f * (z["n_graphs"] + 1 + z["n_params_read"]))}
