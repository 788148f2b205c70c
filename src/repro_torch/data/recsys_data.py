"""Synthetic Criteo-like CTR data and sequential-recommendation streams
(port of ``repro.data.recsys_data``).  Both draw from numpy's
``RandomState`` in the reference's order, so one seed gives the
reference's batch bit for bit; the trainers move it to the card."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..configs.base import RecsysConfig


def ctr_batch(cfg: RecsysConfig, batch: int, *, seed: int = 0
              ) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    out: Dict[str, np.ndarray] = {}
    if cfg.n_dense:
        out["dense"] = rng.lognormal(0, 1, (batch, cfg.n_dense)).astype(
            np.float32)
    vs = np.asarray(cfg.vocab_sizes, np.int64)
    # power-law id popularity (realistic embedding access skew)
    u = rng.random((batch, len(vs)))
    ids = np.floor((vs[None, :]) * u ** 3).astype(np.int64)
    out["sparse_ids"] = np.minimum(ids, vs[None, :] - 1)
    # clicks correlate with a hidden linear model so learning is possible
    w = np.sin(np.arange(len(vs)) + 1)
    logit = (out["sparse_ids"] % 97 / 97.0 - 0.5) @ w
    if cfg.n_dense:
        logit = logit + 0.3 * np.log1p(out["dense"]).sum(1) / cfg.n_dense
    p = 1 / (1 + np.exp(-logit))
    out["label"] = (rng.random(batch) < p).astype(np.float32)
    return out


def seqrec_batch(cfg: RecsysConfig, batch: int, *, seed: int = 0
                 ) -> Dict[str, np.ndarray]:
    """Markov-chain item sequences (so next-item prediction is
    learnable): ``items``, ``pos``, ``neg`` and ``mask`` (B, S) for a
    causal model; for BERT4Rec ``items`` with 20% of the positions set to
    the mask token (n_items + 1), ``labels`` (the masked items, -1
    elsewhere) and 128 sampled ``negatives``."""
    rng = np.random.RandomState(seed)
    S, V = cfg.seq_len, cfg.n_items
    # block-transition structure: item i tends to be followed by i+delta
    start = np.floor(V * rng.random(batch) ** 2).astype(np.int64)
    deltas = rng.randint(1, 5, (batch, S))
    noise = rng.random((batch, S)) < 0.1
    seq = np.empty((batch, S + 1), np.int64)
    seq[:, 0] = start
    for t in range(S):
        nxt = (seq[:, t] + deltas[:, t]) % V
        jump = rng.randint(0, V, batch)
        seq[:, t + 1] = np.where(noise[:, t], jump, nxt)
    items = seq[:, :-1]
    pos = seq[:, 1:]
    neg = rng.randint(0, V, (batch, S))
    mask = np.ones((batch, S), np.float32)
    if cfg.causal:
        return {"items": items, "pos": pos, "neg": neg, "mask": mask}
    # BERT4Rec: mask 20% of positions with the mask token (= V+1)
    mask_tok = V + 1
    m = rng.random((batch, S)) < 0.2
    inp = np.where(m, mask_tok, items)
    labels = np.where(m, items, -1)
    negatives = rng.randint(0, V, (128,))
    return {"items": inp, "labels": labels, "negatives": negatives}
