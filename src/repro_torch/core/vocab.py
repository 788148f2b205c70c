"""Corpus pass: vocabulary with middle-80% frequency filtering + idf (§2.1).

Copy of ``repro.core.vocab``.  Host-side numpy: this is the data-pipeline
part of indexing; the term x segment interaction math runs on the device
(``builder.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np


@dataclass
class Vocabulary:
    """Maps raw token ids -> dense vocab slots [0, |v|) with idf."""

    raw_to_slot: np.ndarray   # (n_raw_tokens,) int32, -1 = filtered/OOV
    slot_to_raw: np.ndarray   # (|v|,) int32
    idf: np.ndarray           # (|v|,) float32
    n_docs: int

    @property
    def size(self) -> int:
        return int(self.slot_to_raw.shape[0])

    def map_tokens(self, raw_tokens: np.ndarray) -> np.ndarray:
        """Vectorised raw-id -> slot mapping (-1 for OOV / filtered)."""
        t = np.asarray(raw_tokens)
        out = np.full(t.shape, -1, np.int32)
        ok = (t >= 0) & (t < self.raw_to_slot.shape[0])
        out[ok] = self.raw_to_slot[t[ok]]
        return out


def build_vocabulary(docs: Sequence[np.ndarray], n_raw_tokens: int, *,
                     keep_frac: Tuple[float, float] = (0.10, 0.90)
                     ) -> Vocabulary:
    """docs: sequences of raw token ids. Drops the most/least frequent tails
    by collection frequency (paper: middle 80%), tracks idf over the pass.
    """
    cf = np.zeros(n_raw_tokens, np.int64)       # collection frequency
    df = np.zeros(n_raw_tokens, np.int64)       # document frequency
    for d in docs:
        d = np.asarray(d)
        d = d[(d >= 0) & (d < n_raw_tokens)]
        if d.size == 0:
            continue
        np.add.at(cf, d, 1)
        df[np.unique(d)] += 1
    present = np.flatnonzero(cf > 0)
    if present.size == 0:
        raise ValueError("empty corpus")
    # rank by collection frequency; keep middle (lo, hi) quantile band
    order = present[np.argsort(cf[present], kind="stable")]
    lo = int(np.floor(keep_frac[0] * order.size))
    hi = int(np.ceil(keep_frac[1] * order.size))
    kept = np.sort(order[lo:hi])
    raw_to_slot = np.full(n_raw_tokens, -1, np.int32)
    raw_to_slot[kept] = np.arange(kept.size, dtype=np.int32)
    n_docs = len(docs)
    idf = np.log(n_docs / (df[kept].astype(np.float64) + 1.0)).astype(np.float32)
    return Vocabulary(raw_to_slot=raw_to_slot, slot_to_raw=kept.astype(np.int32),
                      idf=idf, n_docs=n_docs)
