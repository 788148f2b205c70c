"""Term-range partitioned SEINE index: the serving half.

Port of ``repro.dist.partition.PartitionedIndex`` for codec ``"none"``.
K contiguous term-range shards, each with its own local ``term_offsets``
/ ``doc_ids`` / ``values``, padded to common widths and stacked on a
leading K axis; two small tables route a global term to its shard:

  term_to_shard (|v|,)   global term -> (first) owning shard
  range_lo      (K,)     first global term of each shard

Doc-range sub-shards split a hot term's posting list across consecutive
shards by doc id; ``split_term``/``split_doc`` then make the owner a
function of the (term, doc) pair.  Every pair is resolved against its
owning shard only, so the cross-shard merge is an exclusive write and M
equals the single-CSR lookup bit for bit.  Padding rows are empty
posting lists and are never found.

Building a partition (``partitioned_from_runs`` and the planners) is
build-side and not ported yet; indexes arrive through
``repro_torch.ckpt.load_index`` or ``repro_torch.convert.index_to_device``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass
class PartitionedIndex:
    """K term-range shards of a SegmentInvertedIndex, stacked on axis 0."""
    term_offsets: torch.Tensor  # (K, Vmax+1) int32 shard-local CSR offsets
    doc_ids: torch.Tensor       # (K, Nmax) int32 padded with n_docs
    values: torch.Tensor        # (K, Nmax, n_b, n_f) f32 zero-padded
    term_to_shard: torch.Tensor  # (|v|,) int32 routing table
    range_lo: torch.Tensor      # (K,) int32 first global term of each shard
    idf: torch.Tensor           # (|v|,)
    doc_len: torch.Tensor       # (n_docs,) float32
    seg_len: torch.Tensor       # (n_docs, n_b) float32
    n_docs: int = 0
    vocab_size: int = 0
    n_b: int = 1
    n_shards: int = 1
    functions: Tuple[str, ...] = ()
    # (K, ceil(Nmax/POSTING_TILE)) int32 per-shard fence rows
    fences: Optional[torch.Tensor] = None
    # (K,) int32 last global term (inclusive) with postings in shard k;
    # None (legacy checkpoints) falls back to table-based ownership
    range_hi: Optional[torch.Tensor] = None
    # (K,) int32 doc-range sub-shard tables: split_term[k] is the term
    # continuing into shard k from k-1 (-1 if none), split_doc[k] the
    # first doc id shard k owns of it; None when no term was split
    split_term: Optional[torch.Tensor] = None
    split_doc: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.doc_ids.device

    @property
    def nnz(self) -> int:
        """True stored pairs (padding excluded)."""
        return int(self.term_offsets[:, -1].sum())

    @property
    def nbytes(self) -> int:
        """Total bytes across all shards (padding included)."""
        return sum(a.numel() * a.element_size()
                   for a in (self.term_offsets, self.doc_ids, self.values,
                             self.fences, self.term_to_shard, self.range_lo,
                             self.range_hi, self.split_term, self.split_doc,
                             self.idf, self.doc_len, self.seg_len)
                   if a is not None)

    @property
    def avg_doc_len(self) -> torch.Tensor:
        return self.doc_len.mean()

    def fn_index(self, name: str) -> int:
        return self.functions.index(name)

    # -- lookups (Eq. 4, term-partitioned) ----------------------------------

    def lookup_pairs(self, term_ids: torch.Tensor, doc_ids: torch.Tensor,
                     *, alive=None) -> torch.Tensor:
        """(..., Q) term ids x (...,) doc ids -> (..., Q, n_b, n_f): one
        routed bisect per (term, doc) pair against its owning shard,
        zeros for absent pairs, non-owned terms and dead docs."""
        from ..kernels.csr_lookup import lookup_pairs_ref
        return lookup_pairs_ref(
            self.term_offsets, self.doc_ids, self.values,
            self.term_to_shard, self.range_lo, term_ids, doc_ids,
            self.split_term, self.split_doc, alive=alive)

    def qd_matrix(self, query_terms: torch.Tensor, doc_ids: torch.Tensor,
                  *, impl: Optional[str] = None, tile: Optional[int] = None,
                  alive=None) -> torch.Tensor:
        """query_terms (Q,), doc_ids (B,) -> M_{q,d} (B, Q, n_b, n_f)
        through ``kernels.csr_lookup.csr_lookup`` (``impl`` and ``tile``
        as there)."""
        from ..kernels.csr_lookup import csr_lookup
        return csr_lookup(
            self.term_offsets, self.doc_ids, self.values,
            self.term_to_shard, self.range_lo, query_terms, doc_ids,
            fences=self.fences, split_term=self.split_term,
            split_doc=self.split_doc, tile=tile, impl=impl, alive=alive)

    def retrieve_topk(self, query_terms: torch.Tensor, k: int,
                      score_block_fn, *, doc_block: Optional[int] = None,
                      impl: Optional[str] = None, tile: Optional[int] = None,
                      alive=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """First-stage top-k over the K-stacked layout; the (query,
        shard) lane grid walks each shard's slice of each query term, and
        range-based ownership counts a sub-sharded hot term's docs once."""
        from ..kernels.csr_lookup import csr_retrieve_topk
        return csr_retrieve_topk(
            self.term_offsets, self.doc_ids, self.values,
            self.term_to_shard, self.range_lo, self.range_hi, query_terms,
            n_docs=self.n_docs, k=k, score_block_fn=score_block_fn,
            doc_block=doc_block, tile=tile, impl=impl, alive=alive)
