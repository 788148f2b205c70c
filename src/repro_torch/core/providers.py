"""Embedding providers for SEINE's atomic interaction functions (port of
``repro.core.providers``, without ``LMProvider``, which comes with the
language-model substrate).

The paper uses word2vec (KNRM/HiNT/DeepTileBars) and BERT (DeepCT /
functions 6-9).  No pretrained weights exist here; providers are
pluggable:

* ``HashProvider``    — a fixed random table (word2vec stand-in);
* ``LearnedProvider`` — a trainable table.

The table is drawn from an explicit ``torch.Generator`` or passed in:
``jax.random`` streams cannot be reproduced, so a parity test carries the
reference's table across as numpy (``convert.provider_from_numpy``).

Invariant: the same provider instance is used by the index builder and by
the No-Index on-the-fly path, so `indexed lookup == on-the-fly` holds for
stored pairs.
"""
from __future__ import annotations

import math
from typing import Optional, Protocol

import torch

from ..kernels.utils import resolve_device

# upper bound on segments per doc in the contextual mix (static, as in
# the reference)
N_SEG_CTX = 64


class EmbeddingProvider(Protocol):
    embed_dim: int

    def table(self) -> torch.Tensor: ...
    def contextualize(self, tokens: torch.Tensor,
                      seg_ids: torch.Tensor) -> torch.Tensor: ...


def _normal_table(vocab_size: int, embed_dim: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(vocab_size, embed_dim, generator=generator,
                       dtype=torch.float32) / math.sqrt(embed_dim)


class HashProvider:
    """Fixed random embeddings plus a cheap deterministic 'context' mix:

        contextualize(t, seg) = E[t] + alpha * mean_{t' in seg} E[t'],

    computable identically at build and at query time from the doc alone.
    ``table`` (|v|, De) is used as given; else one is drawn on the CPU
    from ``generator`` (default: seeded with ``seed``) as N(0, 1/De).
    The table lives on ``device`` (default CUDA)."""

    def __init__(self, vocab_size: int, embed_dim: int, *, seed: int = 0,
                 alpha: float = 0.25,
                 generator: Optional[torch.Generator] = None,
                 table: Optional[torch.Tensor] = None, device=None):
        if table is None:
            gen = generator or torch.Generator().manual_seed(seed)
            table = _normal_table(vocab_size, embed_dim, gen)
        if tuple(table.shape) != (vocab_size, embed_dim):
            raise ValueError(f"table must be ({vocab_size}, {embed_dim}), "
                             f"got {tuple(table.shape)}")
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.alpha = alpha
        self._table = table.to(resolve_device(device), torch.float32)

    @property
    def device(self) -> torch.device:
        return self._table.device

    def table(self) -> torch.Tensor:
        return self._table

    def contextualize(self, tokens: torch.Tensor,
                      seg_ids: torch.Tensor) -> torch.Tensor:
        """tokens (..., n) vocab ids (-1 pad), seg_ids (..., n) ->
        contextual embeddings (..., n, De).  Segment ids outside
        [0, 64) add nothing to a segment mean; they read the mean of the
        edge segment, as the reference's clipping gather does."""
        valid = tokens >= 0
        n_v = self._table.shape[0]
        e = self._table[tokens.long().clamp(0, n_v - 1)] * valid[..., None]
        seg = torch.where(valid, seg_ids.long(), N_SEG_CTX - 1)
        in_range = (seg >= 0) & (seg < N_SEG_CTX)
        onehot = (torch.nn.functional.one_hot(seg.clamp(0, N_SEG_CTX - 1),
                                              N_SEG_CTX)
                  * in_range[..., None]).to(e.dtype)       # (..., n, 64)
        seg_sum = onehot.transpose(-1, -2) @ e             # (..., 64, De)
        seg_cnt = (onehot * valid[..., None]).sum(-2)      # (..., 64)
        seg_mean = seg_sum / torch.clamp(seg_cnt, min=1.0)[..., None]
        at = torch.where(seg < 0, seg + N_SEG_CTX, seg).clamp(
            0, N_SEG_CTX - 1)
        mix = torch.gather(seg_mean, -2, at[..., None].expand(e.shape))
        return e + self.alpha * mix * valid[..., None]


class LearnedProvider(HashProvider):
    """The same contextualisation over a trainable table."""

    def __init__(self, table: torch.Tensor, *, alpha: float = 0.25,
                 device=None):
        super().__init__(table.shape[0], table.shape[1], alpha=alpha,
                         table=table, device=device or table.device)

    def with_table(self, table: torch.Tensor) -> "LearnedProvider":
        return LearnedProvider(table, alpha=self.alpha)


def make_provider(name: str, vocab_size: int, embed_dim: int, *,
                  seed: int = 0, generator: Optional[torch.Generator] = None,
                  device=None) -> EmbeddingProvider:
    """The by-name providers: "hash" (fixed random table) or "learned"
    (trainable N(0, 1/De) table), drawn from ``generator`` (default:
    seeded with ``seed``)."""
    gen = generator or torch.Generator().manual_seed(seed)
    if name == "hash":
        return HashProvider(vocab_size, embed_dim, generator=gen,
                            device=device)
    if name == "learned":
        return LearnedProvider(_normal_table(vocab_size, embed_dim, gen),
                               device=resolve_device(device))
    raise ValueError(f"unknown provider {name!r} (the LM provider is not "
                     "ported yet)")
