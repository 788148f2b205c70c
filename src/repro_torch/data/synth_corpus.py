"""Synthetic LETOR-like corpus and Zipfian index (port of
``repro.data.synth_corpus``).  Both draw from numpy's ``RandomState`` in
the reference's order, so one seed gives the same corpus, qrels and
queries, or the same index, in both packages.

Corpus generator design (so SEINE's claims are exercisable):

* a Zipfian unigram background (stopword and misspelling tails included,
  so the middle-80% vocabulary filter has real work to do);
* documents are sequences of 2-5 topical BLOCKS (true TextTiling
  boundaries);
* queries are short samples from 1-2 topics;
* graded relevance (0/1/2) from the overlap between query topics and a
  document's topic mass, as LETOR qrels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..configs.base import SeineConfig
from ..core.index import SegmentInvertedIndex, build_from_rows


@dataclass
class IRDataset:
    docs: List[np.ndarray]            # raw token-id sequences
    queries: List[np.ndarray]         # raw token-id sequences
    qrels: np.ndarray                 # (n_q, n_docs) int8 graded relevance
    n_raw_tokens: int
    doc_topics: np.ndarray            # (n_docs, n_topics) topic mass (diagnostic)
    query_topics: np.ndarray          # (n_q, n_topics)

    def folds(self, k: int = 5, seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
        """LETOR-style k-fold query splits: list of (train_q, test_q)."""
        rng = np.random.RandomState(seed)
        order = rng.permutation(len(self.queries))
        chunks = np.array_split(order, k)
        out = []
        for i in range(k):
            test = chunks[i]
            train = np.concatenate([chunks[j] for j in range(k) if j != i])
            out.append((train, test))
        return out


def generate(cfg: SeineConfig, *, seed: int = 0,
             vocab_per_topic: int = 300, n_background: int = 2000
             ) -> IRDataset:
    rng = np.random.RandomState(seed)
    T = cfg.n_topics
    n_raw = n_background + T * vocab_per_topic

    # Zipfian background distribution over ALL raw tokens
    ranks = np.arange(1, n_raw + 1, dtype=np.float64)
    zipf = 1.0 / ranks ** 1.07
    zipf /= zipf.sum()

    # per-topic distributions: concentrated on the topic's own slice
    topic_token_start = n_background
    topic_dists = []
    for t in range(T):
        p = zipf * 0.35
        sl = slice(topic_token_start + t * vocab_per_topic,
                   topic_token_start + (t + 1) * vocab_per_topic)
        boost = np.zeros(n_raw)
        w = 1.0 / np.arange(1, vocab_per_topic + 1, dtype=np.float64) ** 0.8
        boost[sl] = w / w.sum()
        p = p + 0.65 * boost
        topic_dists.append(p / p.sum())
    topic_dists = np.stack(topic_dists)

    # documents: 2-5 topical blocks (TextTiling ground truth boundaries)
    docs, doc_topics = [], np.zeros((cfg.n_docs, T))
    for i in range(cfg.n_docs):
        n_blocks = rng.randint(2, 6)
        length = max(60, int(rng.normal(cfg.avg_doc_len, cfg.avg_doc_len * 0.3)))
        main_topics = rng.choice(T, size=min(n_blocks, T), replace=False)
        parts = []
        for b in range(n_blocks):
            t = main_topics[b % len(main_topics)]
            blen = max(20, length // n_blocks)
            parts.append(rng.choice(n_raw, size=blen, p=topic_dists[t]))
            doc_topics[i, t] += blen
        doc = np.concatenate(parts)
        doc_topics[i] /= max(doc.size, 1)
        docs.append(doc.astype(np.int32))

    # queries: 2-6 terms from 1-2 topics. Terms are drawn from the
    # mid-frequency band of the topic slice (ranks 2..vocab/3) so they
    # survive the middle-80% collection-frequency vocabulary filter the
    # way real query terms do.
    queries, query_topics = [], np.zeros((cfg.n_queries, T))
    q_lo, q_hi = 3, min(40, vocab_per_topic)   # skip the top-10%-filtered head
    q_ranks = np.arange(q_lo, q_hi)
    q_p = 1.0 / (q_ranks - 1.0) ** 0.7
    q_p /= q_p.sum()
    for i in range(cfg.n_queries):
        n_t = rng.randint(1, 3)
        qt = rng.choice(T, size=n_t, replace=False)
        terms = []
        for t in qt:
            n_terms = rng.randint(2, 4)
            sl0 = topic_token_start + t * vocab_per_topic
            terms.append(sl0 + rng.choice(q_ranks, size=n_terms, p=q_p))
            query_topics[i, t] = 1.0 / n_t
        queries.append(np.concatenate(terms).astype(np.int32)[:6])

    # graded qrels from topic overlap
    sim = query_topics @ doc_topics.T                  # (n_q, n_docs)
    qrels = np.zeros_like(sim, dtype=np.int8)
    qrels[sim > 0.15] = 1
    qrels[sim > 0.40] = 2
    return IRDataset(docs=docs, queries=queries, qrels=qrels,
                     n_raw_tokens=n_raw, doc_topics=doc_topics,
                     query_topics=query_topics)



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
