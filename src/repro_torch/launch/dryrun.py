"""Dry run of every (architecture x input shape) cell on one card and on
the production meshes: count each cell's work on the meta device, and
step the cells that fit on the card (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device meta
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
        --shape train_4k                       # counts, then steps the card
    ... --mesh multi      # count on (2, 16, 16) ("pod", "data", "model")
    ... --mesh both       # (16, 16) ("data", "model") and (2, 16, 16)
    ... --strategy fsdp   # the LM training cells under FSDP
    ... --no-components   # count a LM training cell's first microbatch only
    ... --no-seine        # leave out SEINE's two cells
    ... --jobs 8          # count the cells in 8 processes

Writes one JSON per cell and mesh into ``--out`` (default
``dryrun_results_torch/``), ``{arch}__{shape}__{mesh}[__fsdp].json``, with
the reference's keys, so ``report.py`` reads either package's records.
``--mesh card`` (the default) is the one-card pass below; ``single`` and
``multi`` are the reference's meshes.

Three passes:

* **Count**, on the meta device, for every cell.  Flops come from
  ``torch.utils.flop_counter.FlopCounterMode`` (the matrix products);
  bytes from :class:`ByteCount`, which adds up the bytes of every op's
  tensor inputs and outputs.  That is eager traffic, each op reading its
  inputs from and writing its outputs to memory: an upper bound on what
  a fused step moves.  Meta tensors take the kernels' plain versions
  (every ``ops.py`` sends a tensor that is not on CUDA there); attention
  is counted through ``models.layers.gqa_attention`` at the reference's
  ``attn_chunk`` of 1,024 (the cell's ``count_kwargs``), never the
  kernels' tile-by-tile plain versions, which cost minutes to count at
  full width.  A LM training cell counts its first microbatch with the
  optimizer update and scales one more microbatch by ``accum - 1`` (its
  ``microbatch`` component), where XLA counts a scan body once; every
  other cell is counted whole.  ``lower_s`` is the counting pass's
  seconds.
* **Step on the card**, the counterpart of ``memory_analysis()``, for a
  cell whose argument bytes are at most ``FIT_SHARE`` of the card's
  memory: its arguments are drawn on the card from ``--seed``
  (``Cell.make_args``), the kernels built, and the step run; the peak is
  ``torch.cuda.max_memory_allocated`` over the step (less what was
  allocated before that is not the step's), ``temp_bytes_per_device``
  the peak less the argument bytes, ``compile_s`` the first step's
  seconds and ``step_s`` the last step's.  Any other cell records
  ``"on_card": false``, the reason (its argument bytes, or the step ran
  out of the card's memory), and ``null`` for the card's numbers.
  A step that fails is a failure (``.err``, exit 1); nothing falls back
  to the CPU.
* **Count on a mesh** (``--mesh single | multi | both``), never a step:
  in a process of its own, a world of 256 or 512 ranks on torch's
  ``fake`` backend (``launch.mesh.make_fake_world``), the cell built
  with the mesh, its meta arguments placed as DTensors (each rank's
  local shard a meta tensor of the local shape) and its step run under
  :class:`LocalCount`.  A mode above DTensor sees the global op (a
  ``FlopCounterMode`` counts a 512-way matmul whole), so
  :class:`LocalCount` lets DTensor dispatch first and counts the local
  ops beneath it: ``flops_per_device`` and ``hbm_bytes_per_device`` are
  one device's, ``coll_by_op`` its collectives' result bytes
  (``roofline.collective_bytes``), ``argument_bytes_per_device`` its
  local shards', ``useful_flops_ratio`` ``model_flops / (flops *
  n_devices)`` as in the reference; ``temp`` and ``peak`` are null and
  ``on_card`` false.  ``--strategy fsdp`` with ``--all`` counts the LM
  training cells, the only ones it changes.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from .. import tree as TR
from ..dist.dtensor import is_dtensor
from .roofline import (RooflineTerms, collective_bytes, collective_op,
                       model_flops, terms_from_counts)
from .steps import all_cell_ids, build_cell, is_lm_training

# a cell is stepped on the card when its arguments take at most this
# share of the card's memory
FIT_SHARE = 0.75
OUT_DIR = "dryrun_results_torch"
MESHES = {"single": False, "multi": True}      # name: multi_pod


class ByteCount(TorchDispatchMode):
    """Adds up the bytes of every op's tensor inputs and outputs (views
    move nothing and are skipped), and the flops of the ops it answers
    from its memo.

    On the meta device an op's outputs depend on its inputs' shapes,
    strides and dtypes and its other arguments alone, so an op seen
    before with the same ones is not run again: its outputs are made
    empty from the memo and its bytes and flops (the ``FlopCounterMode``
    count of its first run, read beside it as ``flop_counter``) are
    added again.  A layer's ops and a chunked loop's repeat, which is
    what makes a full-width cell countable in seconds.  Ops that write
    into an argument are always run."""

    def __init__(self, flop_counter: Optional[FlopCounterMode] = None):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.memo_flops = 0
        self._flops = flop_counter
        self._memo: Dict[Any, Tuple[Any, int, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = None
        if func.is_view:            # no bytes, no flops
            with _disable_current_modes():
                return func(*args, **kwargs)
        self.ops += 1
        if self._flops is not None and not func._schema.is_mutable:
            key = _memo_key(func, args, kwargs)
        if key is not None and key in self._memo:
            specs, n_bytes, n_flops = self._memo[key]
            self.bytes += n_bytes
            self.memo_flops += n_flops
            with _disable_current_modes():
                return tree_map(_empty_like_spec, specs)
        before = self._flops.get_total_flops() if key is not None else 0
        out = func(*args, **kwargs)
        n_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves((args, kwargs, out))
                      if isinstance(t, torch.Tensor))
        self.bytes += n_bytes
        if key is not None and all(t.device.type == "meta"
                                   for t in tree_leaves(out)
                                   if isinstance(t, torch.Tensor)):
            self._memo[key] = (tree_map(_spec, out), n_bytes,
                               self._flops.get_total_flops() - before)
        return out


class LocalCount(TorchDispatchMode):
    """One device's count of a step on DTensors: the bytes and flops of
    the local ops each rank runs, and the collectives it issues.

    An op with DTensor arguments is handed on (``NotImplemented``), so
    DTensor's dispatch runs it and its local ops and collectives come
    back through this mode; the global-shape ops DTensor's sharding
    propagation runs on fake tensors are not counted.  Flops are
    ``FlopCounterMode``'s formulas (``flop_registry``) on the local
    shapes; ops answered from the memo add their bytes and flops again,
    as :class:`ByteCount`'s."""

    _PASS = ("_c10d_functional.wait_tensor",
             "_c10d_functional._wrap_tensor_autograd")

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.flops = 0
        self.ops = 0
        self.collectives: list = []
        self._memo: Dict[Any, Tuple[Any, int, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if (func.is_view or _propagating()
                or str(func._overloadpacket) in self._PASS):
            return func(*args, **kwargs)
        if collective_op(func) is not None:
            out = func(*args, **kwargs)
            self.collectives.append((func, out))
            return out
        self.ops += 1
        key = (None if func._schema.is_mutable
               else _memo_key(func, args, kwargs))
        if key is not None and key in self._memo:
            specs, n_bytes, n_flops = self._memo[key]
            self.bytes += n_bytes
            self.flops += n_flops
            with _disable_current_modes():
                return tree_map(_empty_like_spec, specs)
        out = func(*args, **kwargs)
        n_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves((args, kwargs, out))
                      if isinstance(t, torch.Tensor))
        rule = flop_registry.get(func._overloadpacket)
        n_flops = rule(*args, **kwargs, out_val=out) if rule else 0
        self.bytes += n_bytes
        self.flops += n_flops
        if key is not None and all(t.device.type == "meta"
                                   for t in tree_leaves(out)
                                   if isinstance(t, torch.Tensor)):
            self._memo[key] = (tree_map(_spec, out), n_bytes, n_flops)
        return out


def _propagating() -> bool:
    """Whether DTensor's sharding propagation is running an op on fake
    tensors (its global shapes) rather than a rank its local one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


class _Spec(tuple):
    """(shape, stride, dtype) of a memoised meta output."""


def _spec(x):
    if isinstance(x, torch.Tensor):
        return _Spec((tuple(x.shape), x.stride(), x.dtype))
    return x


def _empty_like_spec(x):
    if isinstance(x, _Spec):
        return torch.empty_strided(x[0], x[1], dtype=x[2], device="meta")
    return x


def _memo_key(func, args, kwargs):
    """A key of an op's arguments (tensors by shape, stride, dtype and
    device, plain values as they are), or None when an argument is
    neither."""
    parts = [func]
    for a in tree_leaves((args, kwargs)):
        if isinstance(a, torch.Tensor):
            parts.append((tuple(a.shape), a.stride(), a.dtype,
                          a.device.type))
        elif a is None or isinstance(a, _PLAIN):
            parts.append((type(a), a))
        else:
            return None
    return tuple(parts)


_PLAIN = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
          torch.memory_format)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree (tuples, lists, dicts, named
    tuples, dataclasses such as the index)."""
    if hasattr(tree, "__dataclass_fields__"):
        tree = [getattr(tree, f) for f in tree.__dataclass_fields__]
    if is_dtensor(tree):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return sum(tree_bytes(t) for t in TR.leaves(tree))
    return 0


def count(fn, args, kwargs) -> Tuple[RooflineTerms, Any]:
    """(terms, output) of ``fn(*args, **kwargs)`` run under the flop and
    byte counters."""
    flops = FlopCounterMode(display=False)
    moved = ByteCount(flops)
    with flops, moved:
        out = fn(*args, **kwargs)
    return terms_from_counts(flops.get_total_flops() + moved.memo_flops,
                             moved.bytes), out


def _cache_strided_shard_sizes() -> None:
    """Memoise ``_StridedShard.local_shard_size_and_offset``: DTensor
    computes a strided shard's size (a tensor dimension split over
    several mesh dimensions) by splitting an index tensor into every
    rank's part, at each redistribution, which on a 512-rank mesh is
    most of a count's time.  The sizes depend on the arguments alone, so
    the cache changes no number."""
    from torch.distributed.tensor.placement_types import _StridedShard
    if getattr(_StridedShard, "_seine_cached", False):
        return
    plain = _StridedShard.local_shard_size_and_offset
    memo: Dict[Any, Any] = {}

    @functools.wraps(plain)
    def cached(self, curr_local_size, num_chunks, rank, *rest, **kw):
        key = (self, curr_local_size, num_chunks, rank, rest,
               tuple(sorted(kw.items())))
        if not all(isinstance(k, (int, tuple)) for k in key[1:4]):
            return plain(self, curr_local_size, num_chunks, rank, *rest,
                         **kw)
        if key not in memo:
            memo[key] = plain(self, curr_local_size, num_chunks, rank,
                              *rest, **kw)
        size, off = memo[key]
        return size, list(off) if isinstance(off, list) else off
    _StridedShard.local_shard_size_and_offset = cached
    _StridedShard._seine_cached = True


def count_local(fn, args, kwargs) -> Tuple[RooflineTerms, Any]:
    """(one device's terms, output) of ``fn(*args, **kwargs)`` on placed
    arguments, under :class:`LocalCount`."""
    _cache_strided_shard_sizes()
    moved = LocalCount()
    with moved:
        out = fn(*args, **kwargs)
    return terms_from_counts(moved.flops, moved.bytes,
                             collective_bytes(moved.collectives)), out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finite(t: torch.Tensor, piece: int = 1 << 28) -> bool:
    """Whether every value of ``t`` is finite, read in pieces of
    ``piece`` elements (a decode step returns its whole KV cache: 17 GB
    of bf16 at ``long_500k``, which one ``isfinite`` would double)."""
    return all(bool(torch.isfinite(x).all())
               for x in t.reshape(-1).split(piece))


def step_on_card(cell, device: torch.device, seed: int, repeats: int
                 ) -> Dict[str, Any]:
    """Materialise ``cell``'s arguments on ``device`` and run its step
    ``repeats`` times: the first step's and the last step's seconds and,
    on the card, the peak bytes of the steps (None on the CPU)."""
    cuda = device.type == "cuda"
    if cuda:
        from ..kernels import build_all
        build_all()
    args = cell.make_args(device, seed)
    _sync(device)
    if cuda:
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    secs = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        out = cell.fn(*args)
        _sync(device)
        secs.append(time.perf_counter() - t0)
        if not all(_finite(t) for t in tree_leaves(out)
                   if isinstance(t, torch.Tensor) and t.is_floating_point()):
            raise FloatingPointError(f"{cell.arch_id}/{cell.shape_name}: "
                                     f"the step's outputs are not finite")
        del out
    peak = (torch.cuda.max_memory_allocated(device) - base
            + tree_bytes(args)) if cuda else None
    del args
    return {"compile_s": secs[0], "step_s": secs[-1], "peak_bytes": peak}


def count_cell(arch_id: str, shape_name: str, *, components: bool = True,
               strategy: str = "tp2d", mesh: str = "card") -> dict:
    """A cell's record from the counting pass alone (on the meta device):
    not on the card, no card numbers.  ``mesh`` "single" or "multi"
    counts it placed on that mesh (:func:`count_mesh_cell`)."""
    if mesh != "card":
        return count_mesh_cell(arch_id, shape_name, mesh,
                               components=components, strategy=strategy)
    t0 = time.perf_counter()
    cell = build_cell(arch_id, shape_name, strategy=strategy)
    args = cell.count_args if cell.count_args is not None else cell.args
    terms, out = count(cell.fn, args, cell.count_kwargs)
    comp_info = []
    if components:
        for c in cell.components:
            ct, _ = count(c.fn, c.args, cell.count_kwargs)
            comp_info.append({"name": c.name, "multiplier": c.multiplier,
                              **ct.as_dict()})
            terms = terms.add(ct, k=c.multiplier)
    mf = model_flops(cell.meta, cell.kind)
    return {
        "arch": arch_id, "shape": shape_name, "mesh": "card",
        "n_devices": 1, "kind": cell.kind, "step": cell.step_name,
        "device": "meta",
        "lower_s": round(time.perf_counter() - t0, 2),
        "compile_s": None, "step_s": None,
        "on_card": False, "on_card_reason": "counted only (--device meta)",
        "memory": {
            "argument_bytes_per_device": tree_bytes(cell.args),
            "output_bytes_per_device": tree_bytes(out),
            "temp_bytes_per_device": None,
            "peak_gib_per_device": None,
        },
        "roofline": terms.as_dict(),
        "roofline_share": None,
        "components": comp_info,
        "meta": cell.meta,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / terms.flops
                               if mf and terms.flops else None),
    }


def count_mesh_cell(arch_id: str, shape_name: str, mesh_name: str, *,
                    components: bool = True, strategy: str = "tp2d"
                    ) -> dict:
    """A cell's record counted on the production mesh ``mesh_name`` in a
    fake world (this process joins one of 256 or 512 ranks, and cannot
    then join another): one device's flops, bytes and collectives."""
    from .mesh import make_production_mesh
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name], fake=True)
    n_dev = mesh.size()
    cell = build_cell(arch_id, shape_name, mesh, strategy=strategy)
    args = cell.place(cell.count_args if cell.count_args is not None
                      else cell.args)
    terms, out = count_local(cell.fn, args, cell.count_kwargs)
    comp_info = []
    if components:
        for c in cell.components:
            ct, _ = count_local(c.fn, cell.place(c.args, c.in_shardings),
                                cell.count_kwargs)
            comp_info.append({"name": c.name, "multiplier": c.multiplier,
                              **ct.as_dict()})
            terms = terms.add(ct, k=c.multiplier)
    mf = model_flops(cell.meta, cell.kind)
    return {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "n_devices": int(n_dev), "kind": cell.kind, "step": cell.step_name,
        "device": "meta",
        "lower_s": round(time.perf_counter() - t0, 2),
        "compile_s": None, "step_s": None,
        "on_card": False,
        "on_card_reason": f"counted on a fake world of {n_dev} ranks",
        "memory": {
            "argument_bytes_per_device": tree_bytes(cell.place(cell.args)),
            "output_bytes_per_device": tree_bytes(out),
            "temp_bytes_per_device": None,
            "peak_gib_per_device": None,
        },
        "roofline": terms.as_dict(),
        "roofline_share": None,
        "components": comp_info,
        "meta": cell.meta,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (terms.flops * n_dev)
                               if mf and terms.flops else None),
    }


# rough seconds of a cell's counting pass, by shape: the largest first
_COUNT_COST = {"long_500k": 45.0, "train_4k": 25.0, "prefill_32k": 15.0,
               "decode_32k": 5.0, "index_build": 3.0}


def _deal(cells, jobs: int) -> list:
    """``cells`` dealt, costliest first, into ``jobs`` groups of about
    equal counting cost."""
    groups: list = [[] for _ in range(min(jobs, len(cells)))]
    load = [0.0] * len(groups)
    for cell in sorted(cells, key=lambda c: -_COUNT_COST.get(c[1], 1.0)):
        i = load.index(min(load))
        groups[i].append(cell)
        load[i] += _COUNT_COST.get(cell[1], 1.0)
    return groups


def _spawn(groups, out: str, flags: list, *, extra=None,
           timeout: Optional[float] = None) -> list:
    """One ``python -m repro_torch.launch.dryrun --device meta --cells
    ...`` process a group, writing its records into ``out``, with
    ``flags`` and ``extra[i]`` (group i's own flags); their exit codes.
    Every process still running after ``timeout`` seconds is killed and
    ``subprocess.TimeoutExpired`` raised."""
    import subprocess
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    extra = extra or [[]] * len(groups)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "meta", "--out", out, "--quiet",
         "--cells", ",".join(f"{a}/{s}" for a, s in group)] + flags + more,
        env=env) for group, more in zip(groups, extra, strict=True)]
    deadline = None if timeout is None else time.perf_counter() + timeout
    try:
        return [p.wait(None if deadline is None else
                       max(0.0, deadline - time.perf_counter()))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def count_cells(cells, *, jobs: int = 1, components: bool = True,
                strategy: str = "tp2d") -> Dict[Tuple[str, str], dict]:
    """:func:`count_cell` of every ``(arch, shape)`` on one card.  With
    ``jobs`` > 1 the cells are dealt to ``jobs`` processes of this
    module's command line (counting is host work, one core a process),
    whose records are read back."""
    cells = list(cells)
    if jobs <= 1 or len(cells) <= 1:
        return {(a, s): count_cell(a, s, components=components,
                                   strategy=strategy) for a, s in cells}
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        rcs = _spawn(_deal(cells, jobs), out,
                     ["--strategy", strategy]
                     + ([] if components else ["--no-components"]))
        if any(rcs):
            raise RuntimeError(f"a counting process failed: exit codes {rcs}")
        recs = {}
        for a, s in cells:
            with open(out_path(out, a, s, strategy=strategy)) as f:
                recs[(a, s)] = json.load(f)
    return recs


def run_cell(arch_id: str, shape_name: str, *, device="cuda",
             components: bool = True, verbose: bool = True,
             strategy: str = "tp2d", seed: int = 0, repeats: int = 2,
             counted: Optional[dict] = None) -> dict:
    """One cell's record: counted on the meta device (or ``counted``, a
    record of :func:`count_cell`), then stepped on ``device``
    (``"cuda"``) when it fits; ``device="meta"`` only counts."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be cuda, cpu or meta, got {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a card; count on the CPU "
                           "with --device meta")
    rec = dict(counted) if counted is not None else count_cell(
        arch_id, shape_name, components=components, strategy=strategy)
    rec["memory"] = dict(rec["memory"])
    arg_bytes = rec["memory"]["argument_bytes_per_device"]
    if device.type != "meta":
        cuda = device.type == "cuda"
        rec["device"] = (torch.cuda.get_device_name(device) if cuda
                         else "cpu")
        # the CPU (the tests' small cells) is taken to hold any cell
        total = (torch.cuda.get_device_properties(device).total_memory
                 if cuda else math.inf)
        if arg_bytes <= FIT_SHARE * total:
            cell = build_cell(arch_id, shape_name, strategy=strategy)
            try:
                card = step_on_card(cell, device, seed, repeats)
            except torch.OutOfMemoryError as e:
                # the arguments fit but the step's working set does not
                # (the meta pass sees no peak): a measured misfit
                rec["on_card_reason"] = ("out of memory in the step: "
                                         f"{str(e)[:200]}")
            else:
                peak = card["peak_bytes"]
                rec.update(compile_s=round(card["compile_s"], 3),
                           step_s=card["step_s"], on_card=cuda,
                           on_card_reason=None if cuda else "stepped on "
                           "the CPU",
                           roofline_share=(rec["roofline"]["t_bound_s"]
                                           / card["step_s"]))
                if peak is not None:
                    rec["memory"].update(
                        temp_bytes_per_device=peak - arg_bytes,
                        peak_gib_per_device=round(peak / 2**30, 3))
            finally:
                if cuda:       # the next cell starts from an empty cache
                    torch.cuda.empty_cache()
        else:
            rec["on_card_reason"] = (f"arguments {arg_bytes} bytes > "
                                     f"{FIT_SHARE:.0%} of the card's {total}")
    if verbose:
        rl = rec["roofline"]
        where = (f"step {rec['step_s']:.3f}s, peak "
                 f"{rec['memory']['peak_gib_per_device']} GiB"
                 if rec["step_s"] is not None else f"not stepped: "
                 f"{rec['on_card_reason']}")
        print(f"[dryrun] {arch_id}/{shape_name}: counted in "
              f"{rec['lower_s']:.1f}s, {where}, bottleneck "
              f"{rl['bottleneck']} (c={rl['t_compute_s']:.3e}s "
              f"m={rl['t_memory_s']:.3e}s)", flush=True)
    return rec


def out_path(out_dir: str, arch_id: str, shape_name: str,
             mesh: str = "card", strategy: str = "tp2d") -> str:
    suffix = "" if strategy == "tp2d" else f"__{strategy}"
    return os.path.join(out_dir,
                        f"{arch_id}__{shape_name}__{mesh}{suffix}.json")


def _record(path: str, make) -> bool:
    """Write ``make()``'s record to ``path``; on an error its traceback
    to ``path.err``.  Whether it succeeded."""
    try:
        rec = make()
    except Exception as e:  # noqa: BLE001 — record and continue
        print(f"[dryrun] FAIL {os.path.basename(path)[:-5]}: "
              f"{type(e).__name__}: {e}", flush=True)
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        return False
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return True


def _count_meshes(todo, mesh: str, args) -> int:
    """Count ``todo`` on ``mesh`` ("single" or "multi"): in this process
    with ``--in-process`` (a worker, which joins the fake world), else
    in ``--jobs`` worker processes.  The number of cells that failed."""
    flags = ["--mesh", mesh, "--strategy", args.strategy, "--in-process"] \
        + (["--no-components"] if args.no_components else [])
    if not args.in_process:
        _spawn(_deal(todo, max(1, args.jobs)), args.out, flags)
        return sum(not os.path.exists(out_path(args.out, a, s, mesh,
                                               args.strategy))
                   for a, s in todo)
    n_fail = 0
    for arch_id, shape_name in todo:
        ok = _record(out_path(args.out, arch_id, shape_name, mesh,
                              args.strategy),
                     lambda: count_mesh_cell(
                         arch_id, shape_name, mesh, strategy=args.strategy,
                         components=not args.no_components))
        n_fail += not ok
        if ok and not args.quiet:
            print(f"[dryrun] {arch_id}/{shape_name}/{mesh}: counted",
                  flush=True)
    return n_fail


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-components", action="store_true")
    ap.add_argument("--no-seine", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes that count the cells (host work)")
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch/shape cells")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--strategy", default="tp2d", choices=["tp2d", "fsdp"])
    ap.add_argument("--in-process", action="store_true",
                    help="count mesh cells in this process (a worker)")
    args = ap.parse_args(argv)
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    if ("card" in meshes and args.device == "cuda"
            and not torch.cuda.is_available()):
        print("dryrun: --device cuda needs a card; count on the CPU with "
              "--device meta", file=sys.stderr)
        return 2
    if args.all:
        cells = all_cell_ids(include_seine=not args.no_seine)
        if args.strategy == "fsdp":      # the cells the strategy changes
            cells = [c for c in cells if is_lm_training(*c)]
    elif args.cells:
        cells = [tuple(c.split("/", 1)) for c in args.cells.split(",")]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for mesh in meshes:
        todo = []
        for arch_id, shape_name in cells:
            path = out_path(args.out, arch_id, shape_name, mesh,
                            args.strategy)
            if os.path.exists(path):
                print(f"[dryrun] skip (exists): {path}", flush=True)
            else:
                todo.append((arch_id, shape_name))
        if mesh != "card":
            if todo:
                n_fail += _count_meshes(todo, mesh, args)
            continue
        counted: Dict[Tuple[str, str], dict] = {}
        if args.jobs > 1 and len(todo) > 1:
            counted = count_cells(todo, jobs=args.jobs,
                                  components=not args.no_components,
                                  strategy=args.strategy)
        for arch_id, shape_name in todo:
            n_fail += not _record(
                out_path(args.out, arch_id, shape_name, strategy=args.strategy),
                lambda: run_cell(arch_id, shape_name, device=args.device,
                                 components=not args.no_components,
                                 strategy=args.strategy, seed=args.seed,
                                 verbose=not args.quiet,
                                 counted=counted.get((arch_id, shape_name))))
    if not args.quiet or n_fail:
        print(f"[dryrun] done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
