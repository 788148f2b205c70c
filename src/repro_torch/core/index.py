"""The segment-level inverted index (§2.3–2.4), in PyTorch.

Port of ``repro.core.index``.  Posting-list layout (CSR over terms):

  term_offsets (|v|+1,)            int32 posting-list boundaries
  doc_ids      (nnz,)              int32 docs per term, sorted in each list
  values       (nnz, n_b, n_f)     float32 atomic interaction rows M(w, d)

Only pairs with tf(w, d) > sigma_index are stored; the lookup of an absent
pair returns zeros.  Stored arrays stay int32, as on disk; torch indexes
with int64, so gathers widen their index, and every gather the JAX code
does with ``mode="clip"`` is clamped explicitly here — torch indexing
wraps negative ids and raises past the end.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..kernels.utils import pad_to, resolve_device

# Default posting-tile width of the two-level serving bisect
POSTING_TILE = 256
INT32_MAX = int(np.iinfo(np.int32).max)


def fence_count(n: int, tile: int = POSTING_TILE) -> int:
    """Number of fence entries covering ``n`` postings at ``tile`` spacing
    (at least one, so empty shards keep static shapes)."""
    return -(-max(int(n), 1) // int(tile))


def build_fences(doc_ids: torch.Tensor, tile: int = POSTING_TILE
                 ) -> torch.Tensor:
    """Every ``tile``-th doc id along the last axis: ``(..., N)`` ->
    ``(..., ceil(N/tile))``, the tail padded with int32 max.  Restricted
    to one term's posting range the fences bracket the single tile that
    can hold a lookup target; padding fences are never consulted."""
    n = doc_ids.shape[-1]
    padded = pad_to(doc_ids, doc_ids.ndim - 1, int(tile), value=INT32_MAX)
    if n == 0:
        padded = torch.full(doc_ids.shape[:-1] + (int(tile),), INT32_MAX,
                            dtype=doc_ids.dtype, device=doc_ids.device)
    return padded[..., ::int(tile)].contiguous()


def gather_clip(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` along axis 0 with jnp ``.at[idx].get(mode="clip")``
    semantics: an index in [-n, -1] wraps to ``idx + n`` first (NumPy
    negative indexing), then every index is clamped to [0, n - 1].  So a
    negative candidate doc id -3 reads doc n - 3's stats, as in the
    reference; callers that want -1 to mean "nothing" clamp it to 0
    themselves, as the reference does.

    Under a mesh (DTensor operands) the table is gathered to
    ``Replicate()`` and each rank reads the rows of its own ids: the
    result keeps the ids' splits (``dist.dtensor``)."""
    from ..dist.dtensor import any_dtensor, on_local, sharded_rows
    if any_dtensor(a, idx):
        from torch.distributed.tensor import Replicate
        ref = idx if any_dtensor(idx) else a
        rep = (Replicate(),) * ref.device_mesh.ndim
        pl = sharded_rows(idx) if any_dtensor(idx) else rep
        return on_local(gather_clip, (a, idx), [rep, pl], out_placements=pl)
    n = a.shape[0]
    idx = idx.long()
    return a[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


def _bisect(doc_ids: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
            target: torch.Tensor, n_iter: int = 32) -> torch.Tensor:
    """First position p in [lo, hi) with doc_ids[p] >= target (branchless,
    the same integer ops as ``repro.core.index._bisect``)."""
    lo, hi = torch.broadcast_tensors(lo, hi)
    for _ in range(n_iter):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = gather_clip(doc_ids, mid)
        go_right = (v < target) & (lo < hi)
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right,
                                                                 hi, mid)
    return lo


def csr_lookup_positions(term_offsets: torch.Tensor, doc_ids: torch.Tensor,
                         term_ids: torch.Tensor, doc_targets: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random access into one CSR skeleton: ``(term, doc) -> (pos,
    in_list)``.  ``term_ids`` must already be valid row indices;
    ``in_list`` is True only where the term's list stores the doc."""
    lo = gather_clip(term_offsets, term_ids)
    hi = gather_clip(term_offsets, term_ids + 1)
    pos = _bisect(doc_ids, lo, hi, doc_targets)
    in_list = (pos < hi) & (gather_clip(doc_ids, pos) == doc_targets)
    return pos, in_list


@dataclass
class SegmentInvertedIndex:
    term_offsets: torch.Tensor  # (|v|+1,) int32
    doc_ids: torch.Tensor       # (nnz,) int32
    values: torch.Tensor        # (nnz, n_b, n_f) float32
    idf: torch.Tensor           # (|v|,)
    doc_len: torch.Tensor       # (n_docs,) float32
    seg_len: torch.Tensor       # (n_docs, n_b) float32 tokens per segment
    n_docs: int = 0
    vocab_size: int = 0
    n_b: int = 1
    functions: Tuple[str, ...] = ()
    # (ceil(nnz/POSTING_TILE),) int32 — every POSTING_TILE-th doc id, the
    # first level of the tiled serving bisect
    fences: Optional[torch.Tensor] = None
    # placed on a mesh (dist.sharding.shard_index): ``values`` holds the
    # posting rows [placement.lo, placement.hi) only; None: the whole
    placement: Optional[Any] = None

    @property
    def device(self) -> torch.device:
        return self.doc_ids.device

    @property
    def nnz(self) -> int:
        return int(self.doc_ids.shape[0])

    @property
    def nbytes(self) -> int:
        """The whole index's bytes (every rank's rows, when placed)."""
        if self.placement is not None:
            return self.placement.nbytes
        return self.placed_per_device_nbytes

    @property
    def placed_per_device_nbytes(self) -> int:
        """The bytes of the arrays this rank holds."""
        return sum(a.numel() * a.element_size()
                   for a in (self.term_offsets, self.doc_ids, self.values,
                             self.idf, self.doc_len, self.seg_len,
                             self.fences)
                   if a is not None)

    @property
    def avg_doc_len(self) -> torch.Tensor:
        return self.doc_len.mean()

    def fn_index(self, name: str) -> int:
        return self.functions.index(name)

    # -- lookups (Eq. 4) ----------------------------------------------------

    def lookup_positions(self, term_ids: torch.Tensor, doc_ids: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """term_ids (..., Q), doc_ids broadcastable (...,) ->
        (positions (..., Q), found (..., Q))."""
        w = term_ids.clamp(min=0)
        d = doc_ids[..., None].expand(term_ids.shape)
        pos, in_list = csr_lookup_positions(self.term_offsets, self.doc_ids,
                                            w, d)
        return pos, in_list & (term_ids >= 0)

    def lookup_pairs(self, term_ids: torch.Tensor, doc_ids: torch.Tensor
                     ) -> torch.Tensor:
        """(..., Q) term ids x (...,) doc ids -> (..., Q, n_b, n_f).
        Missing pairs -> zeros.  Placed: each rank reads the rows it
        holds and the parts merge over the mesh."""
        pos, found = self.lookup_positions(term_ids, doc_ids)
        pl = self.placement
        if pl is None:
            vals = gather_clip(self.values, pos)
            return vals * found[..., None, None]
        found = found & (pos >= pl.lo) & (pos < pl.hi)
        vals = gather_clip(self.values, pos - pl.lo)
        return pl.merge(vals * found[..., None, None])

    def lookup_pair_rows(self, terms: torch.Tensor, docs: torch.Tensor
                         ) -> torch.Tensor:
        """Distinct pairs ``terms (P,)`` x ``docs (P,)`` -> (P, n_b, n_f)
        through ``kernels.csr_lookup.csr_lookup_pairs`` (the lookup
        kernel on CUDA, routed per pair)."""
        from ..kernels.csr_lookup import csr_lookup_pairs
        return csr_lookup_pairs(
            self.term_offsets[None], self.doc_ids[None], self.values[None],
            None, None, terms, docs,
            fences=None if self.fences is None else self.fences[None])

    def qd_matrix(self, query_terms: torch.Tensor, doc_ids: torch.Tensor,
                  *, impl: Optional[str] = None, tile: Optional[int] = None
                  ) -> torch.Tensor:
        """query_terms (Q,), doc_ids (B,) -> M_{q,d} (B, Q, n_b, n_f).

        ``impl``: ``None`` is the serving path
        (``kernels.csr_lookup.csr_lookup``: the CUDA kernel for CUDA
        tensors, the routed torch ref on the CPU); ``"ref"`` forces the
        ref on either device; ``"kernel"`` forces the kernel's dataflow,
        which on the CPU runs the kernel's plain per-cell version (the
        parity tests).  ``tile`` overrides the kernel's posting-tile
        width.  Placed on a mesh, each rank looks its rows up through the
        kernel's dataflow (``csr_lookup_held``) and the parts merge by
        ``all_reduce`` over ``model``; ``impl`` must then be None.
        """
        from ..kernels.csr_lookup import csr_lookup, csr_lookup_held
        pl = self.placement
        if pl is not None:
            if impl is not None:
                raise ValueError("a placed index looks up through the "
                                 "kernel's dataflow only; pass impl=None")
            return pl.merge(csr_lookup_held(
                self.term_offsets[None], self.doc_ids[None],
                self.values[None], None, None, query_terms, doc_ids,
                rows=(pl.lo, pl.hi), fences=pl.fences[None], tile=tile))
        return csr_lookup(
            self.term_offsets[None], self.doc_ids[None], self.values[None],
            None, None, query_terms, doc_ids,
            fences=None if self.fences is None else self.fences[None],
            tile=tile, impl=impl)

    def retrieve_topk(self, query_terms: torch.Tensor, k: int,
                      score_block_fn, *, doc_block: Optional[int] = None,
                      impl: Optional[str] = None, tile: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """First-stage top-k over the whole corpus (see
        ``kernels.csr_lookup.csr_retrieve_topk``): ``(scores (k,),
        doc_ids (k,))``, ties toward the lower doc id, ``-inf``/``-1``
        past the corpus."""
        from ..kernels.csr_lookup import csr_retrieve_topk
        return csr_retrieve_topk(
            self.term_offsets[None], self.doc_ids[None], self.values[None],
            None, None, None, query_terms, n_docs=self.n_docs, k=k,
            score_block_fn=score_block_fn, doc_block=doc_block, tile=tile,
            impl=impl)


def build_from_rows(doc_ids: np.ndarray, term_ids: np.ndarray, values, *,
                    idf: np.ndarray, doc_len: np.ndarray,
                    seg_len: np.ndarray, n_docs: int, vocab_size: int,
                    functions: Tuple[str, ...], device=None
                    ) -> SegmentInvertedIndex:
    """Assemble the index from flat (doc, term, value-row) triples.

    The (term, doc) sort runs on the host in numpy, as in
    ``repro.core.index.build_from_rows``.  ``values`` may be a numpy
    array or a tensor already on ``device`` — a real-size payload (GBs)
    is then permuted on the device and never crosses the host."""
    dev = resolve_device(device)
    order = np.lexsort((doc_ids, term_ids))
    t = term_ids[order].astype(np.int64)
    counts = np.bincount(t, minlength=vocab_size)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    sorted_docs = torch.from_numpy(doc_ids[order].astype(np.int32)).to(dev)
    if isinstance(values, torch.Tensor):
        vals = values.to(dev, torch.float32)[
            torch.from_numpy(order).to(dev)]
    else:
        vals = torch.from_numpy(values[order].astype(np.float32)).to(dev)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return SegmentInvertedIndex(
        term_offsets=torch.from_numpy(offsets).to(dev),
        doc_ids=sorted_docs, values=vals,
        fences=build_fences(sorted_docs),
        idf=as_t(idf), doc_len=as_t(doc_len), seg_len=as_t(seg_len),
        n_docs=int(n_docs), vocab_size=int(vocab_size),
        n_b=int(vals.shape[1]), functions=tuple(functions))


def merge_run_parts(parts: list, t_lo: int, t_hi: int, *, n_b: int,
                    n_f: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge ``[(term_ids, doc_ids, values), ...]`` numpy slices, each
    (term, doc)-sorted and restricted to ``[t_lo, t_hi)``, into one local
    CSR: ``(term_offsets (span+1,) int32, doc_ids (n,) int32, values (n,
    n_b, n_f) float32)``.  Rows lexsort by (term, doc) as
    :func:`build_from_rows` orders them; a single part is already sorted
    and skips the sort."""
    span = t_hi - t_lo
    if len(parts) == 1:
        t = parts[0][0].astype(np.int64) - t_lo
        d, v = parts[0][1], parts[0][2]
    elif parts:
        t = np.concatenate([p[0] for p in parts]).astype(np.int64)
        d = np.concatenate([p[1] for p in parts])
        v = np.concatenate([p[2] for p in parts])
        order = np.lexsort((d, t))
        t, d, v = t[order] - t_lo, d[order], v[order]
    else:
        t = np.zeros(0, np.int64)
        d = np.zeros(0, np.int32)
        v = np.zeros((0, n_b, n_f), np.float32)
    counts = np.bincount(t, minlength=max(span, 1))[:max(span, 1)]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return offsets, np.asarray(d, np.int32), np.asarray(v, np.float32)


def shard_csr_from_runs(runs, t_lo: int, t_hi: int, *, n_b: int, n_f: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One term range's local CSR from term-sorted runs (one pass over
    the runs): each contributes the searchsorted slice of ``[t_lo,
    t_hi)``, copied for a spilled run, so host memory is O(range nnz)
    plus one loaded run."""
    parts = []
    for run in runs:
        spilled = getattr(run, "term_ids", None) is None
        t, d, v = run.load()
        lo = int(np.searchsorted(t, t_lo, side="left"))
        hi = int(np.searchsorted(t, t_hi, side="left"))
        if hi > lo:
            sl = (t[lo:hi], d[lo:hi], v[lo:hi])
            parts.append(tuple(a.copy() for a in sl) if spilled else sl)
    return merge_run_parts(parts, t_lo, t_hi, n_b=n_b, n_f=n_f)


def build_shard_from_runs(runs, t_lo: int, t_hi: int, *, idf: np.ndarray,
                          doc_len: np.ndarray, seg_len: np.ndarray,
                          n_docs: int, vocab_size: int, n_b: int,
                          functions: Tuple[str, ...], device=None
                          ) -> SegmentInvertedIndex:
    """ONE term-range shard's local CSR from term-sorted runs
    (``build_pipeline.PostingRun``), on ``device`` (default CUDA): its
    ``term_offsets`` has ``t_hi - t_lo + 1`` rows, ``idf`` is sliced and
    ``vocab_size`` is the span.  With ``(0, |v|)`` this is the global
    index, rows in the (term, doc) order of :func:`build_from_rows`."""
    dev = resolve_device(device)
    offsets, d, v = shard_csr_from_runs(runs, t_lo, t_hi, n_b=n_b,
                                        n_f=len(functions))
    as_t = lambda a, dt: torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dt))).to(dev)
    doc_ids = as_t(d, np.int32)
    return SegmentInvertedIndex(
        term_offsets=as_t(offsets, np.int32), doc_ids=doc_ids,
        values=as_t(v, np.float32), fences=build_fences(doc_ids),
        idf=as_t(np.asarray(idf)[t_lo:t_hi], np.float32),
        doc_len=as_t(doc_len, np.float32), seg_len=as_t(seg_len, np.float32),
        n_docs=int(n_docs), vocab_size=int(t_hi - t_lo), n_b=int(n_b),
        functions=tuple(functions))
