"""LETOR official effectiveness metrics: P@k, nDCG@k, MAP (a copy of
``repro.data.metrics``, host numpy; the port cannot import the
reference, whose package loads JAX)."""
from __future__ import annotations

import numpy as np


def precision_at_k(rels: np.ndarray, k: int) -> float:
    """rels: relevance of ranked docs (descending score order)."""
    return float((rels[:k] > 0).mean()) if rels.size >= 1 else 0.0


def dcg_at_k(rels: np.ndarray, k: int) -> float:
    r = rels[:k].astype(np.float64)
    gains = 2.0 ** r - 1.0
    discounts = 1.0 / np.log2(np.arange(2, r.size + 2))
    return float((gains * discounts).sum())


def ndcg_at_k(rels: np.ndarray, k: int) -> float:
    ideal = np.sort(rels)[::-1]
    idcg = dcg_at_k(ideal, k)
    return dcg_at_k(rels, k) / idcg if idcg > 0 else 0.0


def average_precision(rels: np.ndarray) -> float:
    pos = rels > 0
    if not pos.any():
        return 0.0
    cum = np.cumsum(pos)
    prec = cum / np.arange(1, rels.size + 1)
    return float((prec * pos).sum() / pos.sum())


def evaluate_ranking(scores: np.ndarray, rels: np.ndarray) -> dict:
    """scores, rels: (n_docs,) for one query."""
    order = np.argsort(-scores, kind="stable")
    r = rels[order]
    return {
        "P@5": precision_at_k(r, 5),
        "P@10": precision_at_k(r, 10),
        "MAP": average_precision(r),
        "nDCG@5": ndcg_at_k(r, 5),
        "nDCG@10": ndcg_at_k(r, 10),
    }


def mean_metrics(per_query: list) -> dict:
    keys = per_query[0].keys()
    return {k: float(np.mean([m[k] for m in per_query])) for k in keys}
