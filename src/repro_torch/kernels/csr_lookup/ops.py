"""Public entry points of the serving lookup and the first-stage scan.

Port of ``repro.kernels.csr_lookup.ops`` for codec ``"none"``.  The JAX
op dispatches by backend (the Pallas kernel on TPU, the jnp ref
elsewhere); this one dispatches by the tensors' device:

* a CUDA tensor goes to the hand-written CUDA kernel (``kernel.py``);
* a CPU tensor goes to the routed torch ref lowering (``ref.py``).

``impl`` overrides that choice: ``"ref"`` forces the ref lowering on
either device (the reference a run on the card is checked against), and
``"kernel"`` forces the kernel's dataflow — routing, fences, kernel
wrapper — which on the CPU runs the kernel's plain version (the parity
tests).  A CUDA tensor never falls back to the ref on its own.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.index import POSTING_TILE, build_fences, fence_count
from .kernel import csr_lookup_kernel, retrieve_windows_kernel
from .ref import (_alive_at, csr_lookup_ref, retrieve_lanes, route_pairs,
                  route_terms, scan_block_ref)

IMPLS = (None, "ref", "kernel")


def _use_kernel(impl: Optional[str], like: torch.Tensor, codec: str) -> bool:
    if codec != "none":
        raise NotImplementedError(
            f"codec {codec!r} is not ported yet; the port serves "
            "uncompressed postings (codec='none') only")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; supported: {IMPLS}")
    if impl is None:
        return like.device.type == "cuda"
    return impl == "kernel"


def _mask_dead_rows(out: torch.Tensor, alive, doc_targets: torch.Tensor
                    ) -> torch.Tensor:
    """Zero the rows of dead candidate docs in a kernel's output — equal
    to folding ``alive`` into the found mask, since the mask is per doc
    and not-found rows are +0.0 already."""
    if alive is None:
        return out
    keep = _alive_at(alive, doc_targets)[:, None, None, None]
    return torch.where(keep, out, 0.0)


def csr_lookup(term_offsets: torch.Tensor, doc_ids: torch.Tensor,
               values: torch.Tensor, term_to_shard, range_lo,
               query_terms: torch.Tensor, doc_targets: torch.Tensor, *,
               fences: Optional[torch.Tensor] = None,
               split_term: Optional[torch.Tensor] = None,
               split_doc: Optional[torch.Tensor] = None,
               tile: Optional[int] = None, impl: Optional[str] = None,
               codec: str = "none",
               alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused lookup–merge: query_terms (Q,) x doc_targets (B,) over a
    K-stacked shard CSR -> M_{q,d} (B, Q, n_b, n_f); +0.0 for absent
    pairs, OOV / past-vocab terms and out-of-range doc ids.

    ``term_offsets (K, Vmax+1)`` / ``doc_ids (K, Nmax)`` / ``values (K,
    Nmax, n_b, n_f)`` are the PartitionedIndex layout; the single CSR is
    ``K == 1`` with ``term_to_shard=None``.  ``split_term``/``split_doc``
    are the doc-range sub-shard tables (routing is then per pair);
    ``fences``/``tile`` configure the kernel's two-level bisect; ``alive``
    (n_docs,) bool zeroes the pairs of deleted docs.
    """
    if not _use_kernel(impl, doc_ids, codec):
        return csr_lookup_ref(term_offsets, doc_ids, values, term_to_shard,
                              range_lo, query_terms, doc_targets,
                              split_term, split_doc, alive=alive)
    t = int(tile or POSTING_TILE)
    if split_term is None:
        k, lo, hi = route_terms(query_terms, term_offsets, term_to_shard,
                                range_lo)
    else:
        shape = (query_terms.shape[0], doc_targets.shape[0])     # (Q, B)
        k, lo, hi = route_pairs(
            query_terms[:, None].expand(shape),
            doc_targets[None].expand(shape), term_offsets, term_to_shard,
            range_lo, split_term, split_doc)
    # stored fences are spaced at the build-time POSTING_TILE: rebuild
    # them whenever the requested tile disagrees
    if (fences is None or t != POSTING_TILE
            or fences.shape[1] != fence_count(doc_ids.shape[1], t)):
        fences = build_fences(doc_ids, t)
    as_i32 = lambda a: a.to(torch.int32).contiguous()
    out = csr_lookup_kernel(as_i32(k), as_i32(lo), as_i32(hi),
                            as_i32(doc_targets), doc_ids, fences,
                            values.to(torch.float32), tile=t)
    return _mask_dead_rows(out, alive, doc_targets)


def _block_scanner(term_offsets, doc_ids, values, term_to_shard, range_lo,
                   range_hi, query_terms, block, tile, use_kernel, alive):
    """``blo -> M (block, Q, n_b, n_f)`` with the lanes computed once for
    every block of the scan."""
    lo_f, hi_f = retrieve_lanes(query_terms, term_offsets, term_to_shard,
                                range_lo, range_hi, doc_ids.shape[1])
    if not use_kernel:
        return lambda blo: scan_block_ref(doc_ids, values, lo_f, hi_f, blo,
                                          block, alive=alive)
    t = int(tile or POSTING_TILE)
    lo_f, hi_f = lo_f.contiguous(), hi_f.contiguous()
    vals = values.to(torch.float32)
    arange = torch.arange(block, dtype=torch.int32, device=doc_ids.device)

    def block_m(blo):
        m = retrieve_windows_kernel(doc_ids, vals, lo_f, hi_f, blo, block,
                                    tile=t)
        return _mask_dead_rows(m, alive, blo + arange)
    return block_m


def csr_retrieve_block(term_offsets: torch.Tensor, doc_ids: torch.Tensor,
                       values: torch.Tensor, term_to_shard, range_lo,
                       range_hi, query_terms: torch.Tensor, blo: int, *,
                       block: int, tile: Optional[int] = None,
                       impl: Optional[str] = None, codec: str = "none",
                       alive: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """M rows for docs ``[blo, blo + block)`` x query_terms (Q,) over a
    K-stacked shard CSR -> (block, Q, n_b, n_f), built by walking the
    query's posting lists.  Exact vs the per-pair lookup: exclusive
    shard ownership writes each cell at most once, zeros elsewhere."""
    use_kernel = _use_kernel(impl, doc_ids, codec)
    return _block_scanner(term_offsets, doc_ids, values, term_to_shard,
                          range_lo, range_hi, query_terms, int(block), tile,
                          use_kernel, alive)(int(blo))


def csr_retrieve_topk(term_offsets: torch.Tensor, doc_ids: torch.Tensor,
                      values: torch.Tensor, term_to_shard, range_lo,
                      range_hi, query_terms: torch.Tensor, *, n_docs: int,
                      k: int, score_block_fn,
                      doc_block: Optional[int] = None,
                      tile: Optional[int] = None, impl: Optional[str] = None,
                      codec: str = "none",
                      alive: Optional[torch.Tensor] = None):
    """First-stage top-k: scan the corpus in doc blocks, score each with
    ``score_block_fn(M_block, doc_ids_block) -> (block,)`` and keep a
    running top-k on the device.

    The merge sorts ``cat([running, block_scores])`` descending with a
    STABLE sort — the running entries come first and blocks arrive in
    ascending doc order, so ties break toward the lower doc id, as
    ``lax.top_k`` does in the reference (``torch.topk`` promises no order
    among equal values).  Returns ``(scores (k,), doc_ids (k,))``; when k
    exceeds the corpus the tail carries ``-inf`` and doc id ``-1``.
    ``doc_block`` defaults to the whole corpus up to 1024 docs.  Deleted
    docs (``alive`` False) score ``-inf`` and never enter the top-k.
    """
    n_docs, k = int(n_docs), int(k)
    block = int(doc_block or min(max(n_docs, 1), 1024))
    n_blocks = -(-max(n_docs, 1) // block)
    block_m = _block_scanner(term_offsets, doc_ids, values, term_to_shard,
                             range_lo, range_hi, query_terms, block, tile,
                             _use_kernel(impl, doc_ids, codec), alive)
    dev = doc_ids.device
    run_v = torch.full((k,), -torch.inf, dtype=torch.float32, device=dev)
    run_i = torch.full((k,), -1, dtype=torch.int32, device=dev)
    arange = torch.arange(block, dtype=torch.int32, device=dev)
    for b in range(n_blocks):
        blo = b * block
        docs = blo + arange
        s = score_block_fn(block_m(blo), docs).to(torch.float32)
        s = torch.where(docs < n_docs, s, -torch.inf)
        if alive is not None:
            s = torch.where(_alive_at(alive, docs), s, -torch.inf)
        v = torch.cat([run_v, s])
        top = torch.sort(v, descending=True, stable=True).indices[:k]
        run_v, run_i = v[top], torch.cat([run_i, docs])[top]
    return run_v, run_i


__all__ = ["csr_lookup", "csr_lookup_ref", "csr_retrieve_block",
           "csr_retrieve_topk"]
