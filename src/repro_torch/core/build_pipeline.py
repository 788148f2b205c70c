"""Term-sorted posting runs, the unit the stage-4 merger consumes (port
of the resident half of ``repro.core.build_pipeline.PostingRun``; runs
spilled to disk come with the offline build)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class PostingRun:
    """One term-sorted run of posting triples (doc ascending within
    term), held in host memory."""
    n_rows: int
    nbytes: int
    term_ids: np.ndarray    # (n,) int32, ascending
    doc_ids: np.ndarray     # (n,) int32, ascending within a term
    values: np.ndarray      # (n, n_b, n_f) float32

    @classmethod
    def from_arrays(cls, term_ids: np.ndarray, doc_ids: np.ndarray,
                    values: np.ndarray) -> "PostingRun":
        nbytes = term_ids.nbytes + doc_ids.nbytes + values.nbytes
        return cls(n_rows=int(term_ids.shape[0]), nbytes=nbytes,
                   term_ids=term_ids, doc_ids=doc_ids, values=values)

    def load(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.term_ids, self.doc_ids, self.values

    def ids(self) -> Tuple[np.ndarray, np.ndarray]:
        """(term_ids, doc_ids) without the values payload."""
        return self.term_ids, self.doc_ids

    def term_counts(self, vocab_size: int) -> np.ndarray:
        """(|v|,) int64 postings per term in this run."""
        return np.bincount(self.term_ids, minlength=vocab_size)
