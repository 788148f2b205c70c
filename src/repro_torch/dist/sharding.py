"""Mesh partitioning rules and index placement (port of
``repro.dist.sharding``).

The one place layouts are written down: parameter rules for the model
families, the KV-cache layout of sequence-parallel decode, and the
placement of a built SEINE index on a mesh (posting-list values or the
stacked term-range shards over ``model``, the small tables replicated).
Rules are ordered ``(path regex, PartitionSpec)`` pairs resolved against
a mesh by :func:`tree_shardings`, with :func:`fit_spec`'s divisibility
guard: axes that do not tile a dimension are dropped from the left, so
one rule set fits a 512-rank pod mesh and a 1 x 1 mesh alike.  The
planners cut the global CSR boundary array into K ranges balanced by
posting mass; planning and merging run on the host in numpy, as in the
reference, so the shards are bitwise the reference's.

The port keeps its own :class:`PartitionSpec` (a tuple) and
:class:`NamedSharding` (a mesh and a spec): a ``NamedSharding`` gives
DTensor placements (``Shard(d)`` / ``Replicate()`` per mesh dimension)
and this rank's slice of a full tensor.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` (``launch.mesh``) or, for
rules resolved without a world, an :class:`AbstractMesh`.

JAX runs one controller over every device; the port runs one process
per rank.  A placed index therefore holds this rank's rows or shards
only (its :class:`Placement` says which), every rank takes part in each
lookup, and each entry point returns on every rank what the reference
returns on its one controller: the full M of a lookup (partial M summed
by ``all_reduce`` over ``model``), full scores, and restored trees of
DTensors whose whole tensors are the saved leaves.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from .. import tree as T

# axes that carry batch parallelism, in shrink-first order (drop 'pod'
# first)
_DATA_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), an axis
    name, or a tuple of axis names (the first major); trailing
    dimensions left out are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):           # copy and pickle: P(*entries)
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec
Rules = Sequence[Tuple[str, PartitionSpec]]


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape without ranks behind it, for resolving rules at
    any size (the reference's ``jax.sharding.AbstractMesh``)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or an AbstractMesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's batch-parallel axis names, e.g. ('pod', 'data')."""
    names = mesh_shape(mesh)
    return tuple(a for a in _DATA_AXES if a in names)


def _resolve_entry(mesh, entry, dim: int):
    """Fit one PartitionSpec entry to a dimension: keep only axes present
    in the mesh, then shrink from the left until the shard count divides
    ``dim``."""
    if entry is None:
        return None
    shape = mesh_shape(mesh)
    axes = [a for a in _entry_axes(entry) if a in shape]
    while axes:
        n = int(np.prod([shape[a] for a in axes]))
        if n == 1 or dim % n == 0:
            break
        axes.pop(0)
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def fit_spec(mesh, spec: PartitionSpec, shape: Tuple[int, ...]
             ) -> PartitionSpec:
    """Clamp ``spec`` to ``shape``: trim to rank, drop non-dividing axes."""
    entries = [_resolve_entry(mesh, spec[i] if i < len(spec) else None,
                              shape[i]) for i in range(len(shape))]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


@dataclass(frozen=True)
class NamedSharding:
    """A layout of a tensor on ``mesh``: dimension ``d`` split over the
    axes of ``spec[d]``."""
    mesh: Any
    spec: PartitionSpec = P()

    def _axes(self, dim: int) -> Tuple[str, ...]:
        return _entry_axes(self.spec[dim] if dim < len(self.spec)
                           else None)

    def _parts(self, dim: int) -> int:
        """The number of slices dimension ``dim`` is cut into."""
        sizes = mesh_shape(self.mesh)
        return int(np.prod([sizes[a] for a in self._axes(dim)]))

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dimension."""
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(mesh_shape(self.mesh))
        out = [Replicate()] * len(names)
        for d in range(len(self.spec)):
            idx = [names.index(a) for a in self._axes(d)]
            if idx != sorted(idx):
                raise ValueError(f"{self.spec}: axes of one dimension must "
                                 f"follow the mesh's order {names}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def shard_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The shape of one rank's slice of a ``shape`` tensor."""
        return tuple(n // self._parts(d) for d, n in enumerate(shape))

    def index_range(self, dim: int, size: int) -> Tuple[int, int]:
        """The ``[lo, hi)`` of dimension ``dim`` (of ``size``) this rank
        holds."""
        from ..launch.mesh import axes_rank
        axes = self._axes(dim)
        if not axes:
            return 0, size
        step = size // self._parts(dim)
        i = axes_rank(self.mesh, axes)
        return i * step, (i + 1) * step

    def local_slice(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full tensor ``t``."""
        for d in range(min(len(self.spec), t.ndim)):
            lo, hi = self.index_range(d, t.shape[d])
            if hi - lo != t.shape[d]:
                t = t.narrow(d, lo, hi - lo)
        return t

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's slice of dimension 0 (the
        other dimensions whole), all-gathered in rank order over the
        axes that split it; every rank along them must call."""
        axes = self._axes(0)
        if not axes:
            return local
        from ..launch.mesh import axes_group
        from .collective import all_gather_stack
        parts = all_gather_stack(local, axes_group(self.mesh, axes))
        return parts.reshape((-1,) + tuple(local.shape[1:]))


def _leaf_shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def tree_shardings(mesh, tree: Any, rules: Rules) -> Any:
    """Map every leaf to a NamedSharding via the first matching rule
    (regexes searched against the '/'-joined key path, e.g.
    ``"layers/wq"``); unmatched leaves are replicated.  Containers come
    back plain (a ParamTree as a dict)."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def assign(name, leaf):
        for pat, spec in compiled:
            if pat.search(name):
                return NamedSharding(mesh, fit_spec(mesh, spec,
                                                    _leaf_shape(leaf)))
        return NamedSharding(mesh, P())

    return T.unflatten(tree, [assign(n, leaf) for n, leaf in
                              T.flatten_with_paths(tree)])


# ---------------------------------------------------------------------------
# per-family parameter rules
# ---------------------------------------------------------------------------

def lm_param_rules() -> Rules:
    """Megatron-style 2D tensor parallelism for the stacked-layer LM
    params: column-shard the up-projections, row-shard the
    down-projections, shard the (un)embedding over the vocab dim,
    expert-shard MoE weights."""
    return [
        (r"layers/(wq|wk|wv|w_gate|w_up|ws_gate|ws_up)$",
         P(None, None, "model")),
        (r"layers/(wo|w_down|ws_down)$", P(None, "model", None)),
        (r"layers/(we_gate|we_up|we_down)$", P(None, "model", None, None)),
        (r"layers/router$", P()),
        (r"^embed$", P("model", None)),
        (r"^unembed$", P(None, "model")),
    ]


def lm_param_rules_fsdp() -> Rules:
    """FSDP: every stacked layer param sharded over the flat device grid
    on its first non-layer dim; experts keep expert-parallel placement."""
    flat = ("pod", "data", "model")
    return [
        (r"layers/(we_gate|we_up|we_down)$", P(None, "model", None, None)),
        (r"layers/", P(None, flat)),
        (r"^embed$", P(flat, None)),
        (r"^unembed$", P(None, flat)),
    ]


def gnn_param_rules() -> Rules:
    """GNN (MACE) params are small: every leaf replicated."""
    return []


def recsys_param_rules() -> Rules:
    """Recsys: the embedding tables (row-padded to multiples of 512)
    row-shard over the whole grid; the dense towers stay replicated."""
    flat = ("pod", "data", "model")
    return [
        (r"(^|/)(table|item_emb)$", P(flat, None)),
    ]


def _structure(node):
    """A tree's shape without its leaves (``jax.tree.structure``)."""
    if T.is_leaf(node):
        return "*"
    if node is None:
        return None
    if isinstance(node, tuple):
        kind = "tuple"
    elif isinstance(node, (list, torch.nn.ParameterList,
                           torch.nn.ModuleList)):
        kind = "list"
    else:
        kind = "dict"
    return kind, tuple((k, _structure(v)) for k, v in T._items(node))


def opt_state_shardings(mesh, opt_state: Any, param_shardings: Any
                        ) -> Any:
    """Optimizer-state layout: any sub-tree structured like the params
    (Adam's mu / nu, SGD's momentum) takes the parameter shardings;
    scalars and other statistics are replicated."""
    ptree = _structure(param_shardings)
    rep = NamedSharding(mesh, P())

    def rec(node):
        if node is None:
            return None
        if _structure(node) == ptree:
            return param_shardings
        if T.is_leaf(node):
            return rep
        out = {k: rec(v) for k, v in T._items(node)}
        if isinstance(node, dict):
            return out
        vals = [out[k] for k, _ in T._items(node)]
        return tuple(vals) if isinstance(node, tuple) else vals

    return rec(opt_state)


def lm_cache_spec(mesh, *, seq_shard: bool = True, batch: int = 1
                  ) -> PartitionSpec:
    """PartitionSpec for the (L, B, S, Hkv, hd) KV cache: the sequence
    dim on 'model' (``seq_shard``; the layout ``sp_decode`` merges), the
    batch on the data axes only when it divides them."""
    shape = mesh_shape(mesh)
    da = None
    if batch > 1:
        axes = data_axes(mesh)
        n = int(np.prod([shape[a] for a in axes])) if axes else 1
        if axes and batch % n == 0:
            da = axes if len(axes) > 1 else axes[0]
    seq = "model" if seq_shard and "model" in shape else None
    return P(None, da, seq, None, None)


# ---------------------------------------------------------------------------
# SEINE index placement
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class Placement:
    """What a placed index holds on this rank: rows (a single CSR's
    posting values) or shards (a PartitionedIndex's stacked axis)
    ``[lo, hi)`` of the whole, split over ``axes`` (``()``: every rank
    holds all of them).  ``nnz`` and ``nbytes`` are the whole index's;
    ``fences`` are a single CSR's row slice's own."""
    mesh: Any
    lo: int
    hi: int
    axes: Tuple[str, ...]
    nnz: int
    nbytes: int
    fences: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                       repr=False)

    def merge(self, partial: torch.Tensor) -> torch.Tensor:
        """The whole lookup from this rank's partial one: summed over the
        ranks that split the index (each (term, doc) pair is owned by
        one of them, the others contribute exact zeros)."""
        if not self.axes:
            return partial
        from ..launch.mesh import axes_group
        from .collective import all_reduce_sum
        return all_reduce_sum(partial.contiguous(),
                              axes_group(self.mesh, self.axes))

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leading axis of an array this rank holds ``[lo,
        hi)`` of (every rank of the split must call)."""
        return NamedSharding(self.mesh, P(self.axes)).gather(local)


def _place_all(obj, names, fn):
    return {n: fn(getattr(obj, n)) for n in names
            if getattr(obj, n) is not None}


def index_shardings(mesh, index) -> Any:
    """Shardings for a SegmentInvertedIndex: posting-list values (the
    bulk of the bytes, nnz x n_b x n_f) shard over the model axis; the
    CSR skeleton and per-doc stats replicate, so every rank resolves
    (term, doc) -> position locally."""
    from ..core.index import SegmentInvertedIndex
    rep = NamedSharding(mesh, P())
    vals = NamedSharding(
        mesh, fit_spec(mesh, P("model", None, None),
                       tuple(index.values.shape)))
    return SegmentInvertedIndex(
        term_offsets=rep, doc_ids=rep, values=vals, idf=rep,
        doc_len=rep, seg_len=rep, n_docs=index.n_docs,
        vocab_size=index.vocab_size, n_b=index.n_b,
        functions=index.functions,
        fences=None if index.fences is None else rep)


def shard_index(index, mesh):
    """Place a built SegmentInvertedIndex on ``mesh`` (on this rank's
    device): this rank keeps the value rows ``index_shardings`` gives it
    and the replicated skeleton, and builds fences of its own over its
    rows' doc ids.  Lookups then run over those rows and merge by
    ``all_reduce`` over ``model``."""
    from ..core.index import build_fences
    from ..launch.mesh import mesh_device
    if index.placement is not None:
        if index.placement.mesh is mesh:
            return index
        raise ValueError("the index is already placed on another mesh")
    sh = index_shardings(mesh, index)
    lo, hi = sh.values.index_range(0, index.values.shape[0])
    dev = mesh_device(mesh)
    arrays = _place_all(index, ("term_offsets", "doc_ids", "idf",
                                "doc_len", "seg_len", "fences"),
                        lambda a: a.to(dev))
    placement = Placement(
        mesh, lo, hi, _entry_axes(sh.values.spec[0] if sh.values.spec
                                  else None),
        nnz=index.nnz, nbytes=index.nbytes,
        fences=build_fences(arrays["doc_ids"][lo:hi]))
    return dataclasses.replace(index, values=index.values[lo:hi].to(dev),
                               placement=placement, **arrays)


def gather_index(index):
    """The whole index from a placed one, on every rank of its split
    (each must call): the held rows or shards all-gathered over the
    axes that split them.  An index that is not placed comes back as it
    is."""
    pl = index.placement
    if pl is None:
        return index
    names = (("values",) if not hasattr(index, "term_to_shard") else
             ("term_offsets", "doc_ids", "values", "fences"))
    return dataclasses.replace(index, placement=None,
                               **_place_all(index, names, pl.gather))


def partitioned_index_shardings(mesh, pidx) -> Any:
    """Placement rules for a PartitionedIndex: the stacked shard arrays
    split on their leading K axis over 'model' (each rank holds only its
    term-range shards); the routing table, range starts and per-doc
    stats replicate."""
    from .partition import PartitionedIndex
    rep = NamedSharding(mesh, P())
    shard0 = lambda a: NamedSharding(
        mesh, fit_spec(mesh, P("model"), (a.shape[0],)))
    opt = lambda a, sh: None if a is None else sh
    sh0 = lambda a: None if a is None else shard0(a)
    return PartitionedIndex(
        term_offsets=shard0(pidx.term_offsets),
        doc_ids=sh0(pidx.doc_ids), values=sh0(pidx.values),
        term_to_shard=rep, range_lo=rep, idf=rep, doc_len=rep, seg_len=rep,
        n_docs=pidx.n_docs, vocab_size=pidx.vocab_size, n_b=pidx.n_b,
        n_shards=pidx.n_shards, functions=pidx.functions,
        fences=sh0(pidx.fences),
        range_hi=opt(pidx.range_hi, rep),
        split_term=opt(pidx.split_term, rep),
        split_doc=opt(pidx.split_doc, rep),
        codec=pidx.codec, codec_tile=pidx.codec_tile,
        max_tile_words=pidx.max_tile_words,
        codec_spans=pidx.codec_spans,
        packed_words=sh0(pidx.packed_words),
        tile_bits=sh0(pidx.tile_bits), tile_base=sh0(pidx.tile_base),
        tile_word_off=sh0(pidx.tile_word_off),
        values_q=sh0(pidx.values_q), value_scale=sh0(pidx.value_scale))


def shard_partitioned_index(pidx, mesh):
    """Place a PartitionedIndex on ``mesh`` (on this rank's device) per
    ``partitioned_index_shardings``: this rank keeps the shards ``[lo,
    hi)`` of the leading K axis (all K when ``model`` does not divide
    K) and the replicated tables.  Lookups route every cell, give the
    cells of shards held elsewhere an empty posting window, and merge
    the partial M by ``all_reduce`` over ``model``.  Raw postings only:
    a packed index raises ``ValueError``."""
    from ..launch.mesh import mesh_device
    if pidx.placement is not None:
        if pidx.placement.mesh is mesh:
            return pidx
        raise ValueError("the index is already placed on another mesh")
    if pidx.codec != "none":
        raise ValueError(
            "packed codecs cannot serve under a mesh: the partial-sum "
            "lookup has no packed lowering (serve mesh-less, or build "
            "with codec='none')")
    sh = partitioned_index_shardings(mesh, pidx)
    lo, hi = sh.term_offsets.index_range(0, pidx.n_shards)
    dev = mesh_device(mesh)
    stacked = _place_all(pidx, ("term_offsets", "doc_ids", "values",
                                "fences"), lambda a: a[lo:hi].to(dev))
    common = _place_all(pidx, ("term_to_shard", "range_lo", "range_hi",
                               "split_term", "split_doc", "idf", "doc_len",
                               "seg_len"), lambda a: a.to(dev))
    spec = sh.term_offsets.spec
    placement = Placement(mesh, lo, hi,
                          _entry_axes(spec[0] if spec else None),
                          nnz=pidx.nnz, nbytes=pidx.nbytes)
    return dataclasses.replace(pidx, placement=placement, **stacked,
                               **common)


# ---------------------------------------------------------------------------
# term-range partitioning
# ---------------------------------------------------------------------------

def _record_plan_balance(range_nnz: np.ndarray) -> None:
    """Per-range nnz gauges for the freshly planned cuts (recorded here so
    both planners and every caller feed them)."""
    if not obs.enabled():
        return
    g = obs.gauge("seine_plan_range_nnz", "planned postings per range")
    g.clear()
    for i, n in enumerate(np.asarray(range_nnz)):
        g.set(int(n), range=str(i))


def plan_term_ranges(term_offsets, k: int) -> np.ndarray:
    """Split the vocabulary into ``k`` contiguous term ranges balanced by
    nnz: (k+1,) int64 term boundaries, ``bounds[0] = 0``, ``bounds[k] =
    |v|``, monotone (empty ranges are legal when k exceeds the populated
    terms).  ``term_offsets`` is the global (|v|+1,) boundary array, so
    the k-quantile cuts are one searchsorted."""
    offs = np.asarray(term_offsets, dtype=np.int64)
    if k < 1:
        raise ValueError(f"need k >= 1 shards, got {k}")
    v = len(offs) - 1
    nnz = int(offs[-1])
    targets = (np.arange(1, k, dtype=np.int64) * nnz) // k
    cuts = np.searchsorted(offs, targets, side="left")
    bounds = np.maximum.accumulate(
        np.concatenate([[0], cuts, [v]])).clip(0, v)
    _record_plan_balance(np.diff(offs[bounds]))
    return bounds


def plan_posting_ranges(term_offsets, k: int):
    """Split the posting space into ``k`` nnz-balanced ranges, cutting
    INSIDE a hot posting list (doc-range sub-sharding) when the term
    straddling a quantile target holds more than an even share.

    Returns ``(bounds, ranks)``, both (k+1,) int64: cut ``i`` sits
    ``ranks[i]`` postings into term ``bounds[i]`` (``ranks[i] == 0`` is a
    term-aligned cut).  Without a hot term the ranks are all zero and
    ``bounds == plan_term_ranges(term_offsets, k)``; with a split, the
    global cut positions are repaired to be strictly increasing whenever
    ``nnz >= k``.
    """
    offs = np.asarray(term_offsets, dtype=np.int64)
    if k < 1:
        raise ValueError(f"need k >= 1 shards, got {k}")
    v = len(offs) - 1
    nnz = int(offs[-1])
    counts = np.diff(offs)
    ideal = -(-nnz // k) if nnz else 0
    bounds = np.empty(k + 1, np.int64)
    ranks = np.zeros(k + 1, np.int64)
    bounds[0], bounds[k] = 0, v
    for i, tgt in enumerate((np.arange(1, k, dtype=np.int64) * nnz) // k):
        t = min(max(int(np.searchsorted(offs, tgt, side="right")) - 1, 0),
                max(v - 1, 0))
        if nnz and counts[t] > ideal and tgt > offs[t]:
            bounds[i + 1] = t                         # mid-list: sub-shard
            ranks[i + 1] = tgt - offs[t]
        else:
            bounds[i + 1] = min(
                int(np.searchsorted(offs, tgt, side="left")), v)
    if not ranks.any():
        bounds = np.maximum.accumulate(bounds).clip(0, v)
        _record_plan_balance(np.diff(offs[bounds]))
        return bounds, ranks
    # mixed plan: repair on global posting positions, so no shard is
    # minted empty when the postings allow it
    pos = np.maximum.accumulate(offs[bounds] + ranks)
    if nnz >= k:
        for i in range(1, k):
            pos[i] = min(max(int(pos[i]), int(pos[i - 1]) + 1),
                         nnz - (k - i))
    for i in range(1, k):
        t = int(np.searchsorted(offs, pos[i], side="right")) - 1
        bounds[i], ranks[i] = t, pos[i] - offs[t]
    _record_plan_balance(np.diff(pos))
    return bounds, ranks


def partition_index(index, k: int, *, mesh=None, split_hot: bool = True,
                    codec: str = "none", codec_tile: Optional[int] = None):
    """Split a built SegmentInvertedIndex (on any device) into a K-shard
    PartitionedIndex on the same device: the global CSR is viewed as one
    (term, doc)-sorted posting run and merged by
    ``dist.partition.partitioned_from_runs`` on the host, so the shards
    are bitwise the reference's.  ``split_hot``, ``codec`` and
    ``codec_tile`` as there; with ``mesh`` the result is placed by
    :func:`shard_partitioned_index`."""
    from ..core.build_pipeline import PostingRun
    from .partition import _host, partitioned_from_runs

    if index.placement is not None:
        raise ValueError("partition an index before placing it on a mesh")
    offs = _host(index.term_offsets).astype(np.int64)
    run = PostingRun.from_arrays(
        np.repeat(np.arange(len(offs) - 1, dtype=np.int32), np.diff(offs)),
        _host(index.doc_ids), _host(index.values))
    return partitioned_from_runs(
        [run], k, idf=_host(index.idf), doc_len=_host(index.doc_len),
        seg_len=_host(index.seg_len), n_docs=index.n_docs,
        vocab_size=index.vocab_size, n_b=index.n_b,
        functions=index.functions, mesh=mesh, split_hot=split_hot,
        codec=codec, codec_tile=codec_tile, device=index.device)
