"""Synthetic Zipfian index (port of
``repro.data.synth_corpus.build_zipfian_index``).  It draws from numpy's
``RandomState`` in the reference's order, so one seed gives the same
index in both packages."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.index import SegmentInvertedIndex, build_from_rows

ZIPF_FUNCTIONS = ("tf", "idf_indicator", "dot", "cosine", "gauss_max",
                  "linear_agg", "max_op", "mlp_emb", "log_cond_prob")


def build_zipfian_index(n_docs: int = 64, vocab: int = 40, *,
                        n_hot: int = 1, tail_decay: float = None,
                        min_tail: int = 2, n_b: int = 2,
                        doc_len: float = 10.0, seg_len: float = 5.0,
                        functions: Tuple[str, ...] = ZIPF_FUNCTIONS,
                        seed: int = 0, device=None) -> SegmentInvertedIndex:
    """A synthetic SegmentInvertedIndex with a Zipfian hot-term head: the
    ``n_hot`` leading terms post in every doc; the tail holds ``min_tail``
    postings per term (``tail_decay=None``) or ``~n_docs/(w+1)**decay``
    with that floor.  Values are uniform random."""
    rng = np.random.RandomState(seed)
    doc_ids, term_ids = [], []
    for t in range(n_hot):
        doc_ids.append(np.arange(n_docs))
        term_ids.append(np.full(n_docs, t, np.int64))
    for w in range(n_hot, vocab):
        c = min_tail if tail_decay is None else \
            max(int(n_docs / (w + 1) ** tail_decay), min_tail)
        d = rng.choice(n_docs, size=min(c, n_docs), replace=False)
        doc_ids.append(np.sort(d))
        term_ids.append(np.full(d.size, w, np.int64))
    doc_ids = np.concatenate(doc_ids)
    term_ids = np.concatenate(term_ids)
    vals = rng.rand(len(doc_ids), n_b, len(functions)).astype(np.float32)
    return build_from_rows(
        doc_ids, term_ids, vals, idf=np.ones(vocab, np.float32),
        doc_len=np.full(n_docs, doc_len, np.float32),
        seg_len=np.full((n_docs, n_b), seg_len, np.float32),
        n_docs=n_docs, vocab_size=vocab, functions=tuple(functions),
        device=device)
