"""Batching for ranker training: pairwise (q, d+, d-) sampling with folds,
and padded query arrays (copy of ``repro.data.batching``, host numpy).
Deterministic given seed; the sampler state is checkpointable (a resumed
run restores the stream position).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


def pad_queries(queries: List[np.ndarray], vocab_map, q_len: int = 8) -> np.ndarray:
    """Map raw query tokens -> vocab slots, pad to (n_q, q_len) with -1."""
    out = np.full((len(queries), q_len), -1, np.int32)
    for i, q in enumerate(queries):
        s = vocab_map(q)
        s = s[s >= 0][:q_len]
        out[i, :s.size] = s
    return out


@dataclass
class PairSampler:
    """Yields (query_idx, pos_doc, neg_doc) batches from qrels."""

    qrels: np.ndarray                # (n_q, n_docs)
    query_ids: np.ndarray            # queries of this fold
    batch_size: int
    seed: int = 0
    step: int = 0                    # checkpointable position

    def state_dict(self) -> Dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, s: Dict) -> None:
        self.seed, self.step = int(s["seed"]), int(s["step"])

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + self.step) % 2**31)
        self.step += 1
        B = self.batch_size
        qs = np.empty(B, np.int64)
        pos = np.empty(B, np.int64)
        neg = np.empty(B, np.int64)
        i = 0
        guard = 0
        while i < B:
            guard += 1
            q = self.query_ids[rng.randint(len(self.query_ids))]
            rel = self.qrels[q]
            p_cand = np.flatnonzero(rel > 0)
            n_cand = np.flatnonzero(rel == 0)
            if p_cand.size == 0 or n_cand.size == 0:
                if guard > 10000:
                    raise RuntimeError("qrels degenerate: no pairs")
                continue
            qs[i] = q
            pos[i] = p_cand[rng.randint(p_cand.size)]
            neg[i] = n_cand[rng.randint(n_cand.size)]
            i += 1
        return {"query": qs, "pos": pos, "neg": neg}


def candidates_for_query(qrels_row: np.ndarray, rng: np.random.RandomState,
                         n: int) -> np.ndarray:
    """First-stage candidate pool: all judged docs (LETOR protocol), padded
    with random unjudged docs up to n."""
    judged = np.flatnonzero(qrels_row >= 0)
    pool = np.flatnonzero(qrels_row > 0)
    rest = np.setdiff1d(judged, pool)
    take = np.concatenate([pool, rest])[:n]
    if take.size < n:
        extra = rng.choice(qrels_row.shape[0], size=n - take.size, replace=False)
        take = np.concatenate([take, extra])
    return take.astype(np.int64)
