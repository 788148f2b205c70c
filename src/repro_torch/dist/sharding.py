"""Partition planners and ``partition_index`` (port of the mesh-less half
of ``repro.dist.sharding``).

The planners cut the global CSR boundary array into K ranges balanced
by posting mass; ``partition_index`` splits a built index into a
:class:`~repro_torch.dist.partition.PartitionedIndex` through the
stage-4 merger.  Planning and merging run on the host in numpy, as in
the reference, so the shards are bitwise the reference's.  Both planners
record the planned postings per range (``seine_plan_range_nnz``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import obs


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
    ``codec_tile`` as there; a ``mesh`` is not ported yet and raises."""
    from ..core.build_pipeline import PostingRun
    from .partition import _host, partitioned_from_runs

    if mesh is not None:
        raise NotImplementedError("mesh placement is not ported yet")
    offs = _host(index.term_offsets).astype(np.int64)
    run = PostingRun.from_arrays(
        np.repeat(np.arange(len(offs) - 1, dtype=np.int32), np.diff(offs)),
        _host(index.doc_ids), _host(index.values))
    return partitioned_from_runs(
        [run], k, idf=_host(index.idf), doc_len=_host(index.doc_len),
        seg_len=_host(index.seg_len), n_docs=index.n_docs,
        vocab_size=index.vocab_size, n_b=index.n_b,
        functions=index.functions, split_hot=split_hot, codec=codec,
        codec_tile=codec_tile, device=index.device)
