"""BM25 from the inverted index — conventional tf weights ("bm25") or the
DeepCT contextual term weight stored as SEINE's `linear_agg` atomic
function ("bm25_deepct").  Port of ``repro.retrievers.bm25``."""
from __future__ import annotations

import torch

from .base import QMeta, RetrieverSpec, fidx, make_init, register

K1 = 1.2
B = 0.75


def _bm25(tfd: torch.Tensor, meta: QMeta) -> torch.Tensor:
    """tfd: (B, Q) per-doc term weights -> (B,) BM25 scores."""
    dl = meta.doc_len[:, None]
    norm = K1 * (1.0 - B + B * dl / torch.clamp(meta.avg_dl, min=1.0))
    s = meta.q_idf[None, :] * tfd * (K1 + 1.0) / (tfd + norm)
    return torch.sum(s * meta.q_mask[None, :], dim=1)


init = make_init(lambda gen, n_b: {})


def score(params, M, meta: QMeta, functions) -> torch.Tensor:
    tfd = M[..., fidx(functions, "tf")].sum(-1)        # (B, Q)
    return _bm25(tfd, meta)


def score_deepct(params, M, meta: QMeta, functions) -> torch.Tensor:
    # DeepCT: the learned contextual term weight in place of tf
    w = torch.clamp(M[..., fidx(functions, "linear_agg")], min=0.0).sum(-1)
    present = M[..., fidx(functions, "tf")].sum(-1) > 0
    return _bm25(w * 10.0 * present, meta)


SPEC = register(RetrieverSpec(name="bm25", init=init, score=score,
                              needs=("tf", "idf_indicator")))
SPEC_DEEPCT = register(RetrieverSpec(name="bm25_deepct", init=init,
                                     score=score_deepct,
                                     needs=("tf", "linear_agg")))
