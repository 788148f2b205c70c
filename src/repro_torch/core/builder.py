"""The offline SEINE indexer: corpus -> segment inverted index (port of
``repro.core.builder``, without a mesh; it logs to ``repro.core.build``
as the reference does).

``IndexBuilder.build`` and ``.build_partitioned`` are thin wrappers over
the staged streaming pipeline (``core.build_pipeline.BuildPipeline``):
unique terms, the interaction pass (``seg_interact`` for ``dot``,
``cosine`` and ``gauss_max``), the tf > sigma filter and the row
compaction run on the device, per-batch term-sorted runs go to the host,
and the index is merged from the runs.  The host-list path survives as
:meth:`IndexBuilder.build_legacy`, the parity oracle; :meth:`make_qd_fn`
is the No-Index baseline's query-time computation of M.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..configs.base import SeineConfig
from ..kernels.utils import resolve_device
from .build_pipeline import BuildPipeline, compute_doc_seg_lengths
from .index import SegmentInvertedIndex, build_from_rows
from .interactions import doc_interactions, params_to
from .providers import EmbeddingProvider
from .vocab import Vocabulary

_log = obs.get_logger("repro.core.build")


def unique_terms_host(tokens: np.ndarray, max_uniq: int) -> np.ndarray:
    """Per-doc unique vocab slots padded to max_uniq with -1 (host pass)."""
    n_docs = tokens.shape[0]
    out = np.full((n_docs, max_uniq), -1, np.int32)
    for i in range(n_docs):
        u = np.unique(tokens[i][tokens[i] >= 0])[:max_uniq]
        out[i, :u.size] = u
    return out


def _check_provider_device(table: torch.Tensor, dev: torch.device) -> None:
    if table.device.type != dev.type:
        raise ValueError(f"the provider's table is on {table.device}; the "
                         f"build runs on {dev}: make the provider there")


def make_batch_interaction_fn(provider: EmbeddingProvider,
                              idf: torch.Tensor, ip: Dict[str, Any],
                              n_b: int, functions: Sequence[str], *,
                              device=None):
    """(tokens (B, Lp), segs (B, Lp), uniq (B, U)) -> (B, U, n_b, n_f) on
    ``device`` (default CUDA), one batched pass over the docs."""
    dev = resolve_device(device)
    table = provider.table()
    _check_provider_device(table, dev)
    idf = idf.to(dev)
    ip = params_to(ip, dev)

    def batch_fn(tok: torch.Tensor, seg: torch.Tensor,
                 uniq: torch.Tensor) -> torch.Tensor:
        ctx = provider.contextualize(tok, seg)
        return doc_interactions(tok, seg, uniq, table=table, idf=idf,
                                ctx_emb=ctx, ip=ip, n_b=n_b,
                                functions=functions)

    return batch_fn


class IndexBuilder:
    """Offline SEINE indexer: corpus -> segment inverted index.

    Binds what a build needs — config (interaction functions,
    ``n_segments``, tf threshold), vocabulary (slot mapping + idf) and an
    :class:`~repro_torch.core.providers.EmbeddingProvider` — on
    ``device`` (default CUDA), and exposes two entry points:

    * :meth:`build` — a single :class:`SegmentInvertedIndex` (one global
      CSR, the layout the parity tests compare against);
    * :meth:`build_partitioned` — the production path: K nnz-balanced
      term-range shards merged straight from the streamed runs,
      optionally codec-packed.

    Both are deterministic in the corpus, batch splits included.  The
    telemetry of the last build is kept in :attr:`last_build_stats`.
    ``ip`` defaults to ``init_interaction_params`` from a generator
    seeded with 17.
    """

    def __init__(self, cfg: SeineConfig, vocab: Vocabulary,
                 provider: EmbeddingProvider,
                 ip: Optional[Dict[str, Any]] = None,
                 functions: Optional[Sequence[str]] = None, device=None):
        self.cfg = cfg
        self.vocab = vocab
        self.provider = provider
        self.pipeline = BuildPipeline(cfg, vocab, provider, ip=ip,
                                      functions=functions, device=device)
        self.device = self.pipeline.device
        self.functions = self.pipeline.functions
        self.ip = self.pipeline.ip
        self._idf = self.pipeline._idf
        self.last_build_stats = None

    def build(self, tokens: np.ndarray, seg_ids: np.ndarray, *,
              batch_size: int = 32, max_uniq: Optional[int] = None,
              verbose: bool = False,
              spill_dir: Optional[str] = None) -> SegmentInvertedIndex:
        """tokens/seg_ids: (n_docs, Lp) from ``segment.segment_corpus``.
        ``spill_dir`` bounds resident host bytes by one per-batch run."""
        index, stats = self.pipeline.build_index(
            tokens, seg_ids, batch_size=batch_size, max_uniq=max_uniq,
            spill_dir=spill_dir, verbose=verbose)
        self.last_build_stats = stats
        return index

    def build_partitioned(self, tokens: np.ndarray, seg_ids: np.ndarray,
                          k: int, *, batch_size: int = 32,
                          max_uniq: Optional[int] = None,
                          spill_dir: Optional[str] = None,
                          verbose: bool = False, mesh=None,
                          codec: str = "none",
                          codec_tile: Optional[int] = None):
        """K term-range shards straight from the streamed runs (the
        global CSR is never materialised), packed at merge time under
        ``codec``.  Returns a PartitionedIndex.  ``mesh`` raises."""
        pidx, stats = self.pipeline.build_partitioned(
            tokens, seg_ids, k, batch_size=batch_size, max_uniq=max_uniq,
            spill_dir=spill_dir, verbose=verbose, mesh=mesh, codec=codec,
            codec_tile=codec_tile)
        self.last_build_stats = stats
        return pidx

    def build_legacy(self, tokens: np.ndarray, seg_ids: np.ndarray, *,
                     batch_size: int = 32, max_uniq: Optional[int] = None,
                     verbose: bool = False) -> SegmentInvertedIndex:
        """The host-bound build: per-doc ``np.flatnonzero`` row filtering
        into host lists, then one global CSR.  Kept as the parity oracle
        of the streamed build."""
        n_docs, n_l = tokens.shape
        n_b = self.cfg.n_segments
        max_uniq = max_uniq or min(n_l, 512)
        uniq = unique_terms_host(tokens, max_uniq)
        fn = make_batch_interaction_fn(self.provider, self._idf, self.ip,
                                       n_b, self.functions,
                                       device=self.device)
        rows_d: List[np.ndarray] = []
        rows_t: List[np.ndarray] = []
        rows_v: List[np.ndarray] = []
        tf_i = self.functions.index("tf") if "tf" in self.functions else None
        dev = self.device
        t0 = time.perf_counter()
        for s in range(0, n_docs, batch_size):
            e = min(s + batch_size, n_docs)
            pad = batch_size - (e - s)
            tb = np.pad(tokens[s:e], ((0, pad), (0, 0)), constant_values=-1)
            sb = np.pad(seg_ids[s:e], ((0, pad), (0, 0)),
                        constant_values=n_b - 1)
            ub = np.pad(uniq[s:e], ((0, pad), (0, 0)), constant_values=-1)
            with torch.inference_mode():
                vals = fn(*(torch.from_numpy(a.astype(np.int32)).to(dev)
                            for a in (tb, sb, ub))).cpu().numpy()
            vals = vals[:e - s]
            for i in range(e - s):
                present = ub[i] >= 0
                if tf_i is not None:  # Algorithm 1 line 8: tf > sigma
                    present &= (vals[i, :, :, tf_i].sum(-1)
                                > self.cfg.sigma_index)
                idxs = np.flatnonzero(present)
                rows_d.append(np.full(idxs.size, s + i, np.int32))
                rows_t.append(ub[i, idxs])
                rows_v.append(vals[i, idxs])
            if verbose and (s // batch_size) % 16 == 0:
                _log.info("built", docs=f"{e}/{n_docs}",
                          s=f"{time.perf_counter() - t0:.1f}")
        doc_len, seg_len = compute_doc_seg_lengths(tokens, seg_ids, n_b)
        return build_from_rows(
            np.concatenate(rows_d), np.concatenate(rows_t),
            np.concatenate(rows_v).astype(np.float32),
            idf=self.vocab.idf, doc_len=doc_len, seg_len=seg_len,
            n_docs=n_docs, vocab_size=self.vocab.size,
            functions=self.functions, device=self.device)

    # -- on-the-fly q-d path (the "No Index" baseline) --------------------

    def make_qd_fn(self):
        """(query (Q,), tokens (B, Lp), segs (B, Lp)) -> (B, Q, n_b, n_f).

        The query-time construction of M that SEINE replaces with an
        index lookup.  The build-time pruning (Algorithm 1 line 8: keep
        pairs with tf > sigma_index) applies here too, so M is defined
        over the same pairs and equals the indexed lookup, absent pairs
        included (functions 3-9 are nonzero for terms a doc never
        mentions)."""
        table = self.provider.table()
        _check_provider_device(table, self.device)
        n_b = self.cfg.n_segments
        functions = self.functions
        idf, ip, provider = self._idf, self.ip, self.provider
        sigma = float(self.cfg.sigma_index) if "tf" in functions else 0.0

        def qd_fn(query: torch.Tensor, tok: torch.Tensor,
                  seg: torch.Tensor) -> torch.Tensor:
            terms = query[None].expand(tok.shape[0], -1)
            ctx = provider.contextualize(tok, seg)
            vals = doc_interactions(tok, seg, terms, table=table, idf=idf,
                                    ctx_emb=ctx, ip=ip, n_b=n_b,
                                    functions=functions)
            tf_tot = ((query[None, :, None] == tok[:, None, :])
                      & (tok >= 0)[:, None, :]).sum(-1)
            return vals * (tf_tot > sigma)[..., None, None]

        return qd_fn
