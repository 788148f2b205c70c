"""Dot-product retriever (SNRM-style): the stored `dot` atomic values
summed over query terms and segments.  Port of ``repro.retrievers.dot``."""
from __future__ import annotations

import torch

from .base import QMeta, RetrieverSpec, fidx, make_init, register

init = make_init(lambda gen, n_b: {})


def score(params, M: torch.Tensor, meta: QMeta, functions) -> torch.Tensor:
    d = M[..., fidx(functions, "dot")]                 # (B, Q, n_b)
    return torch.sum(d * meta.q_mask[None, :, None], dim=(1, 2))


SPEC = register(RetrieverSpec(name="dot", init=init, score=score,
                              needs=("dot",)))
