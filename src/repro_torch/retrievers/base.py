"""Retriever interface (port of ``repro.retrievers.base``).

Every retriever is a pure scorer over the q-d interaction matrix
M_{q,d} (B, Q, n_b, n_f); where M came from is invisible to it.
``init(gen, n_b, functions, *, device=None)`` returns the scorer's
parameters as a :class:`~repro_torch.models.layers.ParamTree`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from ..kernels.utils import resolve_device
from ..models.layers import ParamTree


@dataclass
class QMeta:
    q_mask: torch.Tensor    # (Q,) 1.0 for real query terms
    q_idf: torch.Tensor     # (Q,)
    doc_len: torch.Tensor   # (B,)
    seg_len: torch.Tensor   # (B, n_b)
    avg_dl: torch.Tensor    # ()


@dataclass(frozen=True)
class RetrieverSpec:
    name: str
    init: Callable[..., Any]             # (gen, n_b, functions) -> params
    score: Callable[..., torch.Tensor]   # (params, M, meta, functions) -> (B,)
    needs: Tuple[str, ...]               # atomic functions consumed


_REGISTRY: Dict[str, RetrieverSpec] = {}


def register(spec: RetrieverSpec) -> RetrieverSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_retriever(name: str) -> RetrieverSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown retriever {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_retrievers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def fidx(functions: Sequence[str], name: str) -> int:
    return tuple(functions).index(name)


def make_init(build: Callable[[torch.Generator, int], dict]):
    """An ``init(gen, n_b, functions, *, device=None)`` from ``build(gen,
    n_b) -> dict of tensors``: draws on the CPU generator, then moves the
    ParamTree to the resolved device."""
    def init(gen: torch.Generator, n_b: int, functions, *, device=None):
        return ParamTree(build(gen, n_b)).to(resolve_device(device))
    return init


def hinge_pair_loss(score_fn, params, m_pos, m_neg, meta_pos, meta_neg,
                    functions) -> torch.Tensor:
    """Pairwise hinge (the LETOR training objective used for all rankers).
    ``torch.maximum`` against zero, as the reference's ``jnp.maximum``:
    at an exact tie each side takes half the gradient."""
    sp = score_fn(params, m_pos, meta_pos, functions)
    sn = score_fn(params, m_neg, meta_neg, functions)
    x = 1.0 - sp + sn
    return torch.maximum(torch.zeros_like(x), x).mean()
