"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with the
reference's axis names, ``("data", "model")`` or ``("pod", "data",
"model")``.  JAX runs one controller over every device; the port runs
one process per rank, so a mesh needs a process group first:

* under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` set)
  the world it describes is joined;
* otherwise a world of one process is started on a ``FileStore`` in a
  temporary directory (:func:`release_world` ends it).

CUDA meshes run over NCCL, one card per rank (``LOCAL_RANK``); CPU
meshes (``device="cpu"``, the tests) over gloo.  A CUDA world whose NCCL
group fails to start raises: it never becomes a gloo world.  Importing
this module starts nothing.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..kernels.utils import resolve_device

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")

_STARTED: dict = {}     # the world this module started: its store's dir


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def ensure_world(device=None) -> int:
    """The world size, after joining or starting the process group for
    ``device`` (default CUDA).  On CUDA each rank takes the card
    ``LOCAL_RANK`` (0 for a world of one)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if dist.is_initialized():
        if dist.get_backend() != _backend(dev):
            raise RuntimeError(
                f"the process group runs {dist.get_backend()}, but a "
                f"{dev.type} mesh needs {_backend(dev)}")
        return dist.get_world_size()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(_backend(dev), init_method="env://")
        return dist.get_world_size()
    root = tempfile.mkdtemp(prefix="seine_world_")
    store = dist.FileStore(os.path.join(root, "store"), 1)
    dist.init_process_group(_backend(dev), store=store, rank=0,
                            world_size=1)
    _STARTED["root"] = root
    return 1


def release_world() -> None:
    """End the world of one process that :func:`ensure_world` started (a
    world joined under ``torchrun`` is its launcher's to end)."""
    root = _STARTED.pop("root", None)
    if root is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(root, ignore_errors=True)


def _mesh(dev: torch.device, shape: Tuple[int, ...],
          names: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(dev.type, torch.arange(n).view(*shape),
                      mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """A (data, model) mesh over the world's ranks, each axis clamped to
    what the world holds as the reference clamps it to its devices."""
    dev = resolve_device(device)
    n = ensure_world(dev)
    data = max(min(int(data), n), 1)
    model = max(min(int(model), n // data), 1)
    return _mesh(dev, (data, model), AXES)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The pod mesh: (16, 16) over ("data", "model"), or (2, 16, 16) over
    ("pod", "data", "model") with ``multi_pod``; it needs a world of
    exactly 256 or 512 ranks and raises on any other."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise RuntimeError(
            f"the production mesh {shape} needs a world of {need} ranks "
            f"(torchrun --nproc-per-node ...); this one has "
            f"{have or 'no process group'}")
    dev = resolve_device(device)
    ensure_world(dev)
    return _mesh(dev, shape, POD_AXES if multi_pod else AXES)


def mesh_device(mesh) -> torch.device:
    """The device this rank's part of ``mesh`` lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axes_group(mesh, axes: Tuple[str, ...]):
    """The process group of this rank over ``axes`` of ``mesh`` (several
    axes flattened, the first major), as a collective over a
    ``PartitionSpec`` entry of those axes reads it."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten("_".join(axes)).get_group()


def axes_rank(mesh, axes: Tuple[str, ...]) -> Optional[int]:
    """This rank's index along ``axes`` flattened (the first major)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    i = 0
    for a in axes:
        i = i * sizes[a] + coord[a]
    return i
