"""Embedding providers for SEINE's atomic interaction functions (port of
``repro.core.providers``).

The paper uses word2vec (KNRM/HiNT/DeepTileBars) and BERT (DeepCT /
functions 6-9).  No pretrained weights exist here; providers are
pluggable:

* ``HashProvider``    — a fixed random table (word2vec stand-in);
* ``LearnedProvider`` — a trainable table;
* ``LMProvider``      — contextual embeddings from a decoder-only LM
  (``models.transformer``): the bridge from the LM architectures to
  SEINE's index.

Tables and projections are drawn from an explicit ``torch.Generator`` or
passed in: ``jax.random`` streams cannot be reproduced, so a parity test
carries the reference's arrays across as numpy
(``convert.provider_from_numpy``, ``convert.lm_provider_from_numpy``).

Invariant: the same provider instance is used by the index builder and by
the No-Index on-the-fly path, so `indexed lookup == on-the-fly` holds for
stored pairs.
"""
from __future__ import annotations

import math
from typing import Optional, Protocol

import torch

from ..kernels.embed_bag import segment_bag_sums
from ..kernels.utils import resolve_device
from ..models import transformer as T

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
        edge segment, as the reference's clipping gather does.  The
        segment sums go through the ``embed_bag`` kernel for CUDA
        tensors, which has no backward: a table that needs a gradient
        is refused there."""
        valid = tokens >= 0
        n_v = self._table.shape[0]
        e = self._table[tokens.long().clamp(0, n_v - 1)] * valid[..., None]
        seg = torch.where(valid, seg_ids.long(), N_SEG_CTX - 1)
        in_range = (seg >= 0) & (seg < N_SEG_CTX)
        bins = seg.clamp(0, N_SEG_CTX - 1)
        # EmbeddingBag(sum) of each (doc, segment)'s table rows: the
        # embed_bag kernel on CUDA, its plain version on the CPU
        seg_sum = segment_bag_sums(
            self._table, torch.where(valid & in_range, tokens.long(), -1),
            bins, N_SEG_CTX)                               # (..., 64, De)
        onehot = (torch.nn.functional.one_hot(bins, N_SEG_CTX)
                  * in_range[..., None]).to(e.dtype)       # (..., n, 64)
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


class LMProvider:
    """Contextual embeddings from a transformer LM backbone (the SEINE <-
    LM-architecture bridge).

    The static table is the LM's input embedding projected to
    ``embed_dim``; :meth:`contextualize` runs the LM over a batch of
    documents and projects the hidden states.  ``params`` is the tree of
    ``models.transformer.init_params`` (moved to ``device``, default
    CUDA).  The projection ``(d_model, embed_dim)`` is used as given, or
    drawn as N(0, 1/d_model) from ``generator`` (default: seeded with
    ``seed + 7`` on ``device``, the reference's key); none when
    ``embed_dim == d_model``.  ``attention`` is the forward's attention
    (default ``kernels.flash_attn.flash_attention``)."""

    def __init__(self, cfg, params, embed_dim: Optional[int] = None, *,
                 seed: int = 0, generator: Optional[torch.Generator] = None,
                 proj: Optional[torch.Tensor] = None, device=None,
                 attention=None):
        dev = resolve_device(device)
        d = cfg.d_model
        self.cfg = cfg
        self.embed_dim = embed_dim or d
        self.params = _tree_to(params, dev)
        self.attention = attention or T.flash_attention
        if proj is None and self.embed_dim != d:
            gen = generator or torch.Generator(device=dev).manual_seed(
                seed + 7)
            proj = torch.randn(d, self.embed_dim, generator=gen,
                               device=gen.device) / math.sqrt(d)
        if proj is not None and tuple(proj.shape) != (d, self.embed_dim):
            raise ValueError(f"proj must be ({d}, {self.embed_dim}), got "
                             f"{tuple(proj.shape)}")
        self._proj = None if proj is None else proj.to(dev, torch.float32)
        self._table: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x if self._proj is None else x @ self._proj

    def table(self) -> torch.Tensor:
        """(LM vocab, embed_dim) float32, projected once and kept.  SEINE
        vocab slots index it directly; a slot past the LM's vocabulary
        reads the last row (the interactions' clipping gather)."""
        if self._table is None:
            with torch.inference_mode():
                self._table = self._project(self.params["embed"])
        return self._table

    def contextualize(self, tokens: torch.Tensor,
                      seg_ids: torch.Tensor) -> torch.Tensor:
        """tokens (..., n) vocab slots (-1 pad) -> (..., n, embed_dim).
        Every doc of the batch runs through the LM at once; causal
        attention never mixes docs, so each row equals the reference's
        one-doc forward.  Pad and OOV positions enter the LM as token 0
        and are attended (there is no padding mask, as in the
        reference); only their output rows are zeroed."""
        n = tokens.shape[-1]
        valid = tokens >= 0
        hidden, _ = T.forward(self.params, tokens.reshape(-1, n).clamp(min=0),
                              self.cfg, attention=self.attention)
        out = self._project(hidden).reshape(*tokens.shape, -1)
        return out * valid[..., None]


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


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
    raise ValueError(f"unknown provider {name!r} (LMProvider is built "
                     "explicitly)")
