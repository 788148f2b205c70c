"""Dry run of every (architecture x input shape) cell on one card: count
each cell's work on the meta device, and step the cells that fit on the
card (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device meta
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
        --shape train_4k                       # counts, then steps the card
    ... --no-components   # count a LM training cell's first microbatch only
    ... --no-seine        # leave out SEINE's two cells
    ... --jobs 8          # count the cells in 8 processes

Writes one JSON per cell into ``--out`` (default
``dryrun_results_torch/``) with the reference's keys, so ``report.py``
reads either package's records.

Two passes:

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

Only one card and no mesh: ``--mesh`` takes ``single`` and
``--strategy`` ``tp2d``; the others are ROADMAP Queue 1 item 4e.
"""
from __future__ import annotations

import argparse
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
from torch.utils.flop_counter import FlopCounterMode

from .. import tree as TR
from .roofline import RooflineTerms, model_flops, terms_from_counts
from .steps import MESH_ITEM, all_cell_ids, build_cell

# a cell is stepped on the card when its arguments take at most this
# share of the card's memory
FIT_SHARE = 0.75
OUT_DIR = "dryrun_results_torch"


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
               strategy: str = "tp2d") -> dict:
    """A cell's record from the counting pass alone (on the meta device):
    not on the card, no card numbers."""
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
        "arch": arch_id, "shape": shape_name, "mesh": "single",
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


# rough seconds of a cell's counting pass, by shape: the largest first
_COUNT_COST = {"long_500k": 45.0, "train_4k": 25.0, "prefill_32k": 15.0,
               "decode_32k": 5.0, "index_build": 3.0}


def count_cells(cells, *, jobs: int = 1, components: bool = True
                ) -> Dict[Tuple[str, str], dict]:
    """:func:`count_cell` of every ``(arch, shape)``.  With ``jobs`` > 1
    the cells are dealt, costliest first, to ``jobs`` processes of this
    module's command line (``--device meta --cells ...``; counting is
    host work, one core a process), whose records are read back."""
    cells = list(cells)
    if jobs <= 1 or len(cells) <= 1:
        return {(a, s): count_cell(a, s, components=components)
                for a, s in cells}
    import subprocess
    import tempfile
    groups: list = [[] for _ in range(min(jobs, len(cells)))]
    load = [0.0] * len(groups)
    for cell in sorted(cells, key=lambda c: -_COUNT_COST.get(c[1], 1.0)):
        i = load.index(min(load))
        groups[i].append(cell)
        load[i] += _COUNT_COST.get(cell[1], 1.0)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
             "meta", "--out", out, "--quiet",
             "--cells", ",".join(f"{a}/{s}" for a, s in group)]
            + ([] if components else ["--no-components"]), env=env)
            for group in groups]
        rcs = [p.wait() for p in procs]
        if any(rcs):
            raise RuntimeError(f"a counting process failed: exit codes {rcs}")
        recs = {}
        for a, s in cells:
            with open(out_path(out, a, s)) as f:
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


def out_path(out_dir: str, arch_id: str, shape_name: str) -> str:
    return os.path.join(out_dir, f"{arch_id}__{shape_name}__single.json")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
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
    args = ap.parse_args(argv)
    if args.mesh != "single" or args.strategy != "tp2d":
        print(f"dryrun: --mesh {args.mesh} --strategy {args.strategy} needs "
              f"a mesh of cards; this port runs on one: {MESH_ITEM}",
              file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: --device cuda needs a card; count on the CPU with "
              "--device meta", file=sys.stderr)
        return 2
    if args.all:
        cells = all_cell_ids(include_seine=not args.no_seine)
    elif args.cells:
        cells = [tuple(c.split("/", 1)) for c in args.cells.split(",")]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    todo = []
    for arch_id, shape_name in cells:
        path = out_path(args.out, arch_id, shape_name)
        if os.path.exists(path):
            print(f"[dryrun] skip (exists): {path}", flush=True)
        else:
            todo.append((arch_id, shape_name))
    counted: Dict[Tuple[str, str], dict] = {}
    if args.jobs > 1 and len(todo) > 1:
        counted = count_cells(todo, jobs=args.jobs,
                              components=not args.no_components)
    n_fail = 0
    for arch_id, shape_name in todo:
        path = out_path(args.out, arch_id, shape_name)
        try:
            rec = run_cell(arch_id, shape_name, device=args.device,
                           components=not args.no_components,
                           seed=args.seed, verbose=not args.quiet,
                           counted=counted.get((arch_id, shape_name)))
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
        except Exception as e:  # noqa: BLE001 — record and continue
            n_fail += 1
            print(f"[dryrun] FAIL {arch_id}/{shape_name}: "
                  f"{type(e).__name__}: {e}", flush=True)
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
    if not args.quiet or n_fail:
        print(f"[dryrun] done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
